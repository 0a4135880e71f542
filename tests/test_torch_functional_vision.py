"""The port's remaining common functionals and layers, its vision
functionals and its extension functionals against the JAX package's, on
the CPU.

``pad`` (every mode and layout), ``unfold``, ``cosine_similarity``,
``normalize``, ``bilinear``, ``pairwise_distance``; the layers of
``nn/layers_common.py`` (paddings, upsampling, shuffles, ``Bilinear``,
``CosineSimilarity``, ``Unfold``, ``Fold``, ``Identity``);
``affine_grid``, ``grid_sample`` (every mode × padding × corner
alignment, 4-D and 5-D), ``temporal_shift``; ``sequence_mask``,
``gather_tree``, ``sparse_attention``. Each on the same seeded f32
inputs on both sides: the output and the gradient of ``Σ out · w``
(``w`` a fixed random weighting) with respect to every float input,
within ``TOL · (1 + |ref|)``, TOL = 1e-5 (f32, short sums). The random
ones (``feature_alpha_dropout``, the dropout layers,
``class_center_sample``) cannot draw JAX's numbers: they are held to
their laws and to JAX where the draw does not matter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-5
_R = np.random.default_rng(31)


def _f(*shape, scale=1.0):
    return (_R.standard_normal(shape) * scale).astype(np.float32)


def F(P):
    return P.nn.functional


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _run_jax(fn, arrays, diff, w):
    def loss(*arrs):
        out = fn(jpaddle, *[jpaddle.Tensor(a) for a in arrs])._data
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(diff), has_aux=True))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _both(name, fn, arrays, diff=None, tol=TOL):
    if diff is None:
        diff = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    ts = [tpaddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    out = fn(tpaddle, *ts)
    w = np.random.default_rng(3).standard_normal(out.shape).astype(
        np.float32)
    if diff:
        (out * tpaddle.to_tensor(w)).sum().backward()
        want, jgrads = _run_jax(fn, arrays, diff, w)
    else:
        want = np.asarray(fn(jpaddle, *[jpaddle.to_tensor(a)
                                        for a in arrays])._data)
        jgrads = []
    _close(out.numpy(), want, name, tol)
    for i, g in zip(diff, jgrads):
        _close(ts[i].grad.numpy(), g, f"{name} grad {i}", tol)


X4 = _f(2, 3, 5, 6)
X3 = _f(2, 3, 7)
X5 = _f(1, 2, 3, 4, 5)

FUNCTIONALS = [
    ("pad_constant_nchw", lambda P, x: F(P).pad(x, [1, 2, 0, 3], value=0.5),
     [X4]),
    ("pad_every_dim", lambda P, x: F(P).pad(
        x, [0, 1, 1, 0, 2, 1, 1, 2], mode="constant"), [X4]),
    ("pad_reflect_nchw", lambda P, x: F(P).pad(x, [2, 1, 3, 0],
                                               mode="reflect"), [X4]),
    ("pad_reflect_wider_than_axis", lambda P, x: F(P).pad(
        x, [7, 9], mode="reflect", data_format="NCL"), [X3]),
    ("pad_replicate_nhwc", lambda P, x: F(P).pad(
        x, [1, 2, 3, 1], mode="replicate", data_format="NHWC"), [X4]),
    ("pad_circular_ncdhw", lambda P, x: F(P).pad(
        x, [1, 2, 0, 1, 2, 1], mode="circular", data_format="NCDHW"),
     [X5]),
    ("pad_reflect_every_dim", lambda P, x: F(P).pad(
        x, [1, 1, 0, 2, 1, 0, 2, 3], mode="reflect"), [X4]),
    ("pad_circular_nlc", lambda P, x: F(P).pad(
        x, [2, 4], mode="circular", data_format="NLC"),
     [np.ascontiguousarray(X3.transpose(0, 2, 1))]),
    ("unfold", lambda P, x: F(P).unfold(x, 2), [X4]),
    ("unfold_pads_strides_dilation", lambda P, x: F(P).unfold(
        x, [2, 3], strides=[2, 1], paddings=[1, 0, 2, 1], dilations=[1, 2]),
     [X4]),
    ("unfold_pad_pair", lambda P, x: F(P).unfold(x, 3, paddings=[1, 2]),
     [X4]),
    ("cosine_similarity", lambda P, a, b: F(P).cosine_similarity(a, b),
     [X4, _f(2, 3, 5, 6)]),
    ("cosine_similarity_last_axis_eps", lambda P, a, b:
     F(P).cosine_similarity(a, b, axis=-1, eps=1e-2),
     [_f(4, 6, scale=0.05), _f(4, 6, scale=0.05)]),
    ("normalize", lambda P, x: F(P).normalize(x), [X4]),
    ("normalize_p1_axis", lambda P, x: F(P).normalize(x, p=1, axis=-1),
     [X4]),
    ("normalize_p3", lambda P, x: F(P).normalize(x, p=3, axis=2), [X4]),
    ("bilinear", lambda P, a, b, w, bias: F(P).bilinear(a, b, w, bias),
     [_f(4, 3), _f(4, 5), _f(6, 3, 5), _f(6)]),
    ("bilinear_no_bias", lambda P, a, b, w: F(P).bilinear(a, b, w),
     [_f(4, 3), _f(4, 5), _f(6, 3, 5)]),
    ("pairwise_distance", lambda P, a, b: F(P).pairwise_distance(a, b),
     [_f(4, 7), _f(4, 7)]),
    ("pairwise_distance_p1_keepdim", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=1.0, keepdim=True), [_f(3, 4, 7), _f(3, 4, 7)]),
    ("pairwise_distance_inf", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=float("inf")), [_f(4, 7), _f(4, 7)]),
    ("pairwise_distance_neg_inf", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=float("-inf"), epsilon=0.0), [_f(4, 7), _f(4, 7)]),
    ("temporal_shift", lambda P, x: F(P).temporal_shift(x, 3, 0.25),
     [_f(6, 8, 3, 4)]),
    ("temporal_shift_nhwc", lambda P, x: F(P).temporal_shift(
        x, 2, 0.125, data_format="NHWC"), [_f(4, 3, 2, 16)]),
    ("sequence_mask", lambda P, x: F(P).sequence_mask(x),
     [np.asarray([[3, 0, 5], [1, 2, 4]], np.int64)]),
    ("sequence_mask_maxlen_f32", lambda P, x: F(P).sequence_mask(
        x, maxlen=7, dtype="float32"), [np.asarray([3, 0, 6], np.int64)]),
    ("gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
     [np.random.default_rng(4).integers(0, 9, (5, 2, 3)).astype(np.int64),
      np.random.default_rng(5).integers(0, 3, (5, 2, 3)).astype(np.int64)]),
]


@pytest.mark.parametrize("name,fn,arrays", FUNCTIONALS,
                         ids=[f[0] for f in FUNCTIONALS])
def test_functional_matches_jax(name, fn, arrays):
    _both(name, fn, arrays)


def _grid(n, *out, scale=1.2, seed=6):
    return (np.random.default_rng(seed).uniform(-scale, scale,
                                                (n, *out, len(out)))
            .astype(np.float32))


GRID = [(mode, pad, ac) for mode in ("bilinear", "nearest")
        for pad in ("zeros", "border", "reflection")
        for ac in (True, False)]


@pytest.mark.parametrize("mode,padding,align", GRID,
                         ids=[f"{m}-{p}-{a}" for m, p, a in GRID])
def test_grid_sample_matches_jax(mode, padding, align):
    """Grid points up to 1.2 outside [-1, 1], so every padding rule is
    reached; the 4-D and the 5-D (trilinear) input. ``nearest`` has no
    gradient with respect to the grid (JAX's is zero)."""
    fn = lambda P, x, g: F(P).grid_sample(  # noqa: E731
        x, g, mode=mode, padding_mode=padding, align_corners=align)
    diff = [0, 1] if mode == "bilinear" else [0]
    _both("grid_sample_4d", fn, [_f(2, 3, 6, 7), _grid(2, 5, 4)], diff)
    _both("grid_sample_5d", fn, [_f(1, 2, 4, 5, 6), _grid(1, 3, 2, 4)],
          diff)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_matches_jax_and_feeds_grid_sample(align):
    """The grids, and a ``grid_sample`` of one: its gradient with
    respect to ``theta`` sums ~200 products of the two packages'
    ``linspace`` points (which differ in their last bits), held at
    1e-4."""
    r = np.random.default_rng(13)
    theta = (np.eye(2, 3)[None] + r.standard_normal((2, 2, 3)) * 0.2) \
        .astype(np.float32)
    _both("affine_grid", lambda P, t: F(P).affine_grid(
        t, [2, 3, 5, 7], align_corners=align), [theta])
    theta3 = (np.eye(3, 4)[None] + r.standard_normal((1, 3, 4)) * 0.1) \
        .astype(np.float32)
    _both("affine_grid_3d", lambda P, t: F(P).affine_grid(
        t, [1, 2, 3, 4, 5], align_corners=align), [theta3])
    _both("affine_grid_then_grid_sample", lambda P, t, x: F(P).grid_sample(
        x, F(P).affine_grid(t, [2, 3, 5, 7], align_corners=align),
        align_corners=align), [theta, r.standard_normal((2, 3, 6, 8))
                               .astype(np.float32)], tol=1e-4)


def _csr(b, h, m, seed):
    """A random CSR pattern with one row left empty a (batch, head)."""
    r = np.random.default_rng(seed)
    offs, cols = [], []
    nnz = None
    for _ in range(b * h):
        keep = r.uniform(size=(m, m)) < 0.4
        keep[r.integers(0, m)] = False
        rows = [np.nonzero(k)[0] for k in keep]
        off = np.concatenate([[0], np.cumsum([len(c) for c in rows])])
        col = np.concatenate(rows)
        offs.append(off)
        cols.append(col)
        nnz = len(col) if nnz is None else min(nnz, len(col))
    # every (batch, head) takes the same nnz: trim the tails
    offs = [np.minimum(o, nnz) for o in offs]
    cols = [c[:nnz] for c in cols]
    return (np.stack(offs).reshape(b, h, m + 1).astype(np.int32),
            np.stack(cols).reshape(b, h, nnz).astype(np.int32))


@pytest.mark.parametrize("masks", ["none", "key_padding", "both"])
def test_sparse_attention_matches_jax(masks):
    b, h, m, d = 2, 2, 6, 4
    q, k, v = _f(b, h, m, d), _f(b, h, m, d), _f(b, h, m, d)
    off, cols = _csr(b, h, m, 7)
    kpm = (np.random.default_rng(8).uniform(size=(b, m)) > 0.2).astype(
        np.float32)
    am = (np.random.default_rng(9).uniform(size=(b, h, m, m)) > 0.1).astype(
        np.float32)
    extra = {"none": [], "key_padding": [kpm], "both": [kpm, am]}[masks]

    def fn(P, q_, k_, v_, o_, c_, *rest):
        kw = {}
        if rest:
            kw["key_padding_mask"] = rest[0]
        if len(rest) > 1:
            kw["attn_mask"] = rest[1]
        return F(P).sparse_attention(q_, k_, v_, o_, c_, **kw)
    _both("sparse_attention", fn, [q, k, v, off, cols] + extra,
          diff=[0, 1, 2])
    out = fn(tpaddle, *[tpaddle.to_tensor(a)
                        for a in [q, k, v, off, cols] + extra]).numpy()
    empty = off[..., 1:] == off[..., :-1]
    assert empty.any() and not out[empty].any()


LAYERS = [
    ("Pad1D", lambda N: N.Pad1D([1, 2], mode="reflect"), [X3]),
    ("Pad2D", lambda N: N.Pad2D([1, 0, 2, 1], mode="replicate"), [X4]),
    ("Pad2D_constant_nhwc", lambda N: N.Pad2D([1, 1, 1, 1], value=2.0,
                                              data_format="NHWC"), [X4]),
    ("Pad3D", lambda N: N.Pad3D([1, 0, 0, 1, 1, 1], mode="circular"), [X5]),
    ("ZeroPad2D", lambda N: N.ZeroPad2D([2, 1, 0, 1]), [X4]),
    ("Upsample_bilinear", lambda N: N.Upsample(scale_factor=2,
                                               mode="bilinear"), [X4]),
    ("Upsample_size_nearest", lambda N: N.Upsample(size=[7, 9]), [X4]),
    ("UpsamplingBilinear2D", lambda N: N.UpsamplingBilinear2D(
        size=[3, 4]), [X4]),
    ("UpsamplingNearest2D", lambda N: N.UpsamplingNearest2D(
        scale_factor=2), [X4]),
    ("PixelShuffle", lambda N: N.PixelShuffle(2), [_f(2, 8, 3, 4)]),
    ("PixelShuffle_nhwc", lambda N: N.PixelShuffle(2, "NHWC"),
     [_f(2, 3, 4, 8)]),
    ("PixelUnshuffle", lambda N: N.PixelUnshuffle(2), [_f(2, 2, 4, 6)]),
    ("ChannelShuffle", lambda N: N.ChannelShuffle(3), [_f(2, 6, 3, 2)]),
    ("ChannelShuffle_nhwc", lambda N: N.ChannelShuffle(2, "NHWC"),
     [_f(2, 3, 2, 6)]),
    ("CosineSimilarity", lambda N: N.CosineSimilarity(axis=2),
     [X4, _f(2, 3, 5, 6)]),
    ("Unfold", lambda N: N.Unfold([2, 2], strides=2), [_f(2, 3, 6, 4)]),
    ("Fold", lambda N: N.Fold([4, 5], 2, strides=1, paddings=1),
     [_f(2, 12, 30)]),
    ("Identity", lambda N: N.Identity(3, foo=1), [X4]),
]


@pytest.mark.parametrize("name,make,arrays", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, make, arrays):
    tl, jl = make(tpaddle.nn), make(jpaddle.nn)
    _both(name, lambda P, *xs: (tl if P is tpaddle else jl)(*xs), arrays)


def test_bilinear_layer_matches_jax():
    tpaddle.seed(2)
    tl = tpaddle.nn.Bilinear(3, 5, 4)
    jl = jpaddle.nn.Bilinear(3, 5, 4)
    assert tuple(tl.weight.shape) == (4, 3, 5)
    assert not tl.bias.numpy().any()
    sd = {"weight": _f(4, 3, 5), "bias": _f(4)}
    tl.set_state_dict(sd)
    jl.set_state_dict(sd)
    _both("Bilinear", lambda P, a, b: (tl if P is tpaddle else jl)(a, b),
          [_f(6, 3), _f(6, 5)])


def test_unported_op_rows_left():
    from paddle_tpu_torch.ops import op_registry
    for name in ("pad", "unfold", "cosine_similarity", "normalize",
                 "bilinear"):
        assert op_registry.resolve(name) is getattr(
            tpaddle.nn.functional, name), name


# -- the random ones ----------------------------------------------------------

def test_feature_alpha_dropout_keeps_one_mask_a_channel():
    x = np.abs(_f(4, 6, 5, 5)) + 0.5
    tpaddle.seed(11)
    out = tpaddle.nn.functional.feature_alpha_dropout(
        tpaddle.to_tensor(x), 0.5).numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 0.5
    a = (q + alpha_p ** 2 * q * (1 - q)) ** -0.5
    b = -a * alpha_p * (1 - q)
    kept = np.isclose(out, a * x + b, rtol=1e-6)
    dropped = np.isclose(out, a * alpha_p + b, rtol=1e-6)
    assert (kept | dropped).all()
    per_map = kept.reshape(4, 6, -1)
    # a whole feature map is kept or dropped
    assert (per_map.all(-1) | ~per_map.any(-1)).all()
    assert per_map.all(-1).any() and (~per_map.any(-1)).any()
    # eval and p = 0 pass the input through, as in JAX
    for kw in (dict(training=False), dict(p=0.0)):
        got = tpaddle.nn.functional.feature_alpha_dropout(
            tpaddle.to_tensor(x), **{"p": 0.5, **kw})
        np.testing.assert_array_equal(got.numpy(), x)
    with pytest.raises(ValueError):
        tpaddle.nn.functional.feature_alpha_dropout(tpaddle.to_tensor(x),
                                                    1.0)
    # the mask is a counted host draw, like alpha_dropout's
    from paddle_tpu_torch.core import random as trandom
    before = trandom.draws()
    tpaddle.nn.functional.feature_alpha_dropout(tpaddle.to_tensor(x), 0.3)
    assert trandom.draws() == before + 1


@pytest.mark.parametrize("cls,shape,axes", [
    ("Dropout2D", (4, 5, 3, 3), (2, 3)),
    ("Dropout3D", (2, 5, 2, 3, 3), (2, 3, 4)),
])
def test_axis_dropout_layers_drop_whole_channels(cls, shape, axes):
    x = np.abs(_f(*shape)) + 1.0
    layer = getattr(tpaddle.nn, cls)(p=0.5)
    out = layer(tpaddle.to_tensor(x)).numpy()
    kept = out != 0
    assert (kept.all(axes) | ~kept.any(axes)).all()
    np.testing.assert_allclose(out[kept], x[kept] * 2.0, rtol=1e-6)
    layer.eval()
    np.testing.assert_array_equal(layer(tpaddle.to_tensor(x)).numpy(), x)
    jl = getattr(jpaddle.nn, cls)(p=0.5)
    jl.eval()
    np.testing.assert_array_equal(np.asarray(jl(jpaddle.to_tensor(x))._data),
                                  x)


def test_alpha_dropout_layer():
    x = _f(64, 32)
    layer = tpaddle.nn.AlphaDropout(0.2)
    out = layer(tpaddle.to_tensor(x)).numpy()
    assert out.shape == x.shape and not np.array_equal(out, x)
    layer.eval()
    np.testing.assert_array_equal(layer(tpaddle.to_tensor(x)).numpy(), x)


def test_class_center_sample_matches_jax_where_the_draw_does_not_matter():
    label = np.asarray([3, 7, 3, 1, 9, 7], np.int64)
    # as many samples as positives: no negative is drawn
    got = tpaddle.nn.functional.class_center_sample(
        tpaddle.to_tensor(label), 12, 4)
    want = jpaddle.nn.functional.class_center_sample(
        jpaddle.to_tensor(label), 12, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._data))
    # with negatives: every positive kept, sorted, labels remapped
    remapped, sampled = tpaddle.nn.functional.class_center_sample(
        tpaddle.to_tensor(label), 20, 8)
    s = sampled.numpy()
    assert len(s) == 8 and (np.diff(s) > 0).all()
    assert set(label) <= set(s)
    np.testing.assert_array_equal(s[remapped.numpy()], label)
    # torch in, torch out
    r, _ = tpaddle.nn.functional.class_center_sample(
        torch.from_numpy(label), 20, 8)
    assert isinstance(r, torch.Tensor)

    class Group:
        nranks = 2
    with pytest.raises(NotImplementedError, match="distributed"):
        tpaddle.nn.functional.class_center_sample(
            tpaddle.to_tensor(label), 20, 8, group=Group())

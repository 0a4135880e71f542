"""The port's convolution and pooling functionals against the JAX
package's, on the CPU.

Each case runs on the same f32 inputs (numpy, seeded) on both sides, in
the layout it names: the output, and the gradient of ``sum(out * w)``
(``w`` a fixed random weighting) with respect to every float input
(the JAX side as one jitted ``value_and_grad`` over the JAX
functional).
Tolerance: ``|got - want| <= TOL · (1 + |want|)``, TOL = 2e-5 (f32 on
both sides; a convolution sums up to a few hundred products, which
cuDNN-free CPU kernels of the two packages add in other orders). The
max-pool cases feed ReLU'd inputs, so many windows are all zeros: the
gradient must go to each window's first maximum in both layouts, as in
ResNet's stem. Layers match their JAX Layers from copied weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 2e-5

_R = np.random.default_rng(11)


def _f(*shape):
    return _R.standard_normal(shape).astype(np.float32)


def _relu(*shape):
    return np.maximum(_f(*shape), 0.0)


def F(P):
    return P.nn.functional


def _t(a):
    """NCHW-style array to channel-last."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


X4 = _f(2, 4, 7, 7)
W4 = _f(6, 4, 3, 3)
B6 = _f(6)
X3 = _f(2, 4, 9)
X5 = _f(2, 3, 5, 6, 4)

# (id, function of (package, *tensors), numpy inputs)
CONV = [
    ("conv2d_pad1", lambda P, x, w, b: F(P).conv2d(x, w, b, padding=1),
     [X4, W4, B6]),
    ("conv2d_nhwc_same_s2", lambda P, x, w, b: F(P).conv2d(
        x, w, b, stride=2, padding="SAME", data_format="NHWC"),
     [_t(X4), W4, B6]),
    ("conv2d_nchw_same_s2_k4", lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding="same"), [X4, _f(6, 4, 4, 4)]),
    ("conv2d_valid", lambda P, x, w: F(P).conv2d(x, w, padding="VALID"),
     [X4, W4]),
    ("conv2d_pads_2n", lambda P, x, w: F(P).conv2d(
        x, w, padding=[0, 1, 2, 1], stride=(2, 1)), [X4, W4]),
    ("conv2d_pad_pairs_nhwc", lambda P, x, w: F(P).conv2d(
        x, w, padding=[(1, 0), (2, 1)], data_format="NHWC"),
     [_t(X4), W4]),
    ("conv2d_groups_dilation_nhwc", lambda P, x, w, b: F(P).conv2d(
        x, w, b, padding=2, dilation=2, groups=2, data_format="NHWC"),
     [_t(X4), _f(6, 2, 3, 3), B6]),
    ("conv2d_depthwise", lambda P, x, w: F(P).conv2d(
        x, w, padding=1, groups=4), [X4, _f(4, 1, 3, 3)]),
    ("conv1d", lambda P, x, w, b: F(P).conv1d(x, w, b, padding=1, stride=2),
     [X3, _f(5, 4, 3), _f(5)]),
    ("conv1d_nlc_same", lambda P, x, w: F(P).conv1d(
        x, w, padding="SAME", data_format="NLC"),
     [_t(X3), _f(5, 4, 4)]),
    ("conv3d", lambda P, x, w: F(P).conv3d(x, w, padding=1), [X5,
                                                              _f(2, 3, 3, 3,
                                                                 3)]),
    ("conv3d_ndhwc", lambda P, x, w: F(P).conv3d(
        x, w, stride=2, padding=[1, 0, 1, 1, 0, 1], data_format="NDHWC"),
     [_t(X5), _f(2, 3, 2, 3, 3)]),
    ("conv2d_transpose", lambda P, x, w, b: F(P).conv2d_transpose(
        x, w, b, stride=2, padding=1, output_padding=1), [X4, _f(4, 3, 3, 3),
                                                          _f(3)]),
    ("conv2d_transpose_nhwc_groups", lambda P, x, w: F(P).conv2d_transpose(
        x, w, stride=2, groups=2, data_format="NHWC"),
     [_t(X4), _f(4, 3, 3, 3)]),
    ("conv2d_transpose_asym", lambda P, x, w: F(P).conv2d_transpose(
        x, w, stride=2, padding=[0, 2, 1, 0], dilation=2),
     [X4, _f(4, 2, 3, 3)]),
    ("conv2d_transpose_big_pad", lambda P, x, w: F(P).conv2d_transpose(
        x, w, padding=[3, 3], output_padding=0), [X4, _f(4, 2, 3, 3)]),
    ("conv1d_transpose", lambda P, x, w: F(P).conv1d_transpose(
        x, w, stride=3, padding=1), [X3, _f(4, 2, 3)]),
    ("conv3d_transpose", lambda P, x, w: F(P).conv3d_transpose(
        x, w, stride=2, padding=1), [X5, _f(3, 2, 3, 3, 3)]),
]

R4 = _relu(2, 3, 8, 8)
R4b = _relu(2, 3, 9, 7)
POOL = [
    ("max_pool2d_stem", lambda P, x: F(P).max_pool2d(x, 3, 2, 1), [R4]),
    ("max_pool2d_stem_nhwc", lambda P, x: F(P).max_pool2d(
        x, 3, 2, 1, data_format="NHWC"), [_t(R4)]),
    ("max_pool2d_ties_all_zero", lambda P, x: F(P).max_pool2d(
        x, 2, 1, 0), [np.zeros((1, 2, 4, 4), np.float32)]),
    ("max_pool2d_ties_all_zero_nhwc", lambda P, x: F(P).max_pool2d(
        x, 2, 1, 0, data_format="NHWC"),
     [np.zeros((1, 4, 4, 2), np.float32)]),
    ("max_pool2d_ceil", lambda P, x: F(P).max_pool2d(
        x, 3, 2, 0, ceil_mode=True), [R4b]),
    ("max_pool2d_ceil_nhwc", lambda P, x: F(P).max_pool2d(
        x, 2, 2, 1, ceil_mode=True, data_format="NHWC"), [_t(R4b)]),
    ("max_pool2d_asym", lambda P, x: F(P).max_pool2d(
        x, 3, 2, [1, 0, 2, 1]), [R4b]),
    ("max_pool2d_same", lambda P, x: F(P).max_pool2d(x, 3, 2, "SAME"),
     [R4b]),
    ("max_pool1d", lambda P, x: F(P).max_pool1d(x, 3, 2, 1), [X3]),
    ("max_pool3d", lambda P, x: F(P).max_pool3d(x, 2, 2), [X5]),
    ("avg_pool2d", lambda P, x: F(P).avg_pool2d(x, 3, 2, 1), [R4b]),
    ("avg_pool2d_inclusive_nhwc", lambda P, x: F(P).avg_pool2d(
        x, 3, 2, 1, exclusive=False, data_format="NHWC"), [_t(R4b)]),
    ("avg_pool2d_ceil", lambda P, x: F(P).avg_pool2d(
        x, 3, 2, 1, ceil_mode=True), [R4b]),
    ("avg_pool2d_ceil_inclusive", lambda P, x: F(P).avg_pool2d(
        x, 2, 2, 0, ceil_mode=True, exclusive=False), [R4b]),
    ("avg_pool2d_same", lambda P, x: F(P).avg_pool2d(x, 3, 2, "SAME"),
     [R4b]),
    ("avg_pool2d_asym_nhwc", lambda P, x: F(P).avg_pool2d(
        x, 3, 1, [[0, 2], [1, 0]], data_format="NHWC"), [_t(R4b)]),
    ("avg_pool1d", lambda P, x: F(P).avg_pool1d(x, 3, 2, 1), [X3]),
    ("avg_pool1d_ceil", lambda P, x: F(P).avg_pool1d(
        x, 2, 2, 0, ceil_mode=True), [X3]),
    ("avg_pool3d", lambda P, x: F(P).avg_pool3d(x, 2, 2, 1), [X5]),
    ("adaptive_avg_pool2d_1x1_nhwc", lambda P, x: F(P).adaptive_avg_pool2d(
        x, (1, 1), data_format="NHWC"), [_t(R4)]),
    ("adaptive_avg_pool2d_buckets", lambda P, x:
     F(P).adaptive_avg_pool2d(x, (4, 3)), [R4b]),
    ("adaptive_avg_pool1d", lambda P, x: F(P).adaptive_avg_pool1d(x, 4),
     [X3]),
    ("adaptive_avg_pool3d", lambda P, x: F(P).adaptive_avg_pool3d(
        x, (2, 4, 3)), [X5]),
    ("adaptive_max_pool2d", lambda P, x: F(P).adaptive_max_pool2d(
        x, (4, 3)), [R4b]),
    ("adaptive_max_pool1d", lambda P, x: F(P).adaptive_max_pool1d(x, 2),
     [X3]),
    ("adaptive_max_pool3d", lambda P, x: F(P).adaptive_max_pool3d(
        x, 2), [X5]),
    ("lp_pool2d", lambda P, x: F(P).lp_pool2d(x + 0.5, 2, 3, 2), [R4b]),
    ("lp_pool1d", lambda P, x: F(P).lp_pool1d(x, 3.0, 2), [np.abs(X3)]),
    ("fractional_max_pool2d", lambda P, x: F(P).fractional_max_pool2d(
        x, (5, 4), random_u=0.3), [R4b]),
    ("fractional_max_pool3d_kernel", lambda P, x:
     F(P).fractional_max_pool3d(x, (2, 3, 3), kernel_size=2,
                                random_u=0.6), [X5]),
]


def _run_jax(fn, arrays, w):
    """The JAX side as one jitted ``value_and_grad`` (one compile where
    the eager tape compiles every op)."""
    def loss(*arrs):
        out = fn(jpaddle, *[jpaddle.Tensor(a) for a in arrs])._data
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # a window wholly in the padding pools to -inf on both sides
    same = got == want
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0,
                       np.abs(got - want) - TOL * (1 + np.abs(want)))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _both(name, fn, arrays):
    ts = [tpaddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(tpaddle, *ts)
    w = np.random.default_rng(3).standard_normal(out.size).astype(
        np.float32).reshape(out.shape)
    (out * tpaddle.to_tensor(w)).sum().backward()
    want, jgrads = _run_jax(fn, arrays, w)
    _close(out.numpy(), want, name)
    for i, (t, j) in enumerate(zip(ts, jgrads)):
        _close(t.grad.numpy(), j, f"{name} grad {i}")


@pytest.mark.parametrize("name,fn,arrays", CONV, ids=[c[0] for c in CONV])
def test_conv_matches_jax_forward_and_gradient(name, fn, arrays):
    _both(name, fn, arrays)


@pytest.mark.parametrize("name,fn,arrays", POOL, ids=[c[0] for c in POOL])
def test_pool_matches_jax_forward_and_gradient(name, fn, arrays):
    _both(name, fn, arrays)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_max_pool_gradient_on_ties_goes_to_the_first_maximum(layout):
    """An all-zero input: every 2×2 window ties, so each output's
    cotangent lands on its window's first element (row-major), and
    overlapping windows add up there."""
    x = np.zeros((1, 1, 3, 3), np.float32)
    if layout == "NHWC":
        x = _t(x)
    t = tpaddle.to_tensor(x, stop_gradient=False)
    out = tpaddle.nn.functional.max_pool2d(t, 2, 1, 0, data_format=layout)
    out.sum().backward()
    g = t.grad.numpy().reshape(3, 3)
    np.testing.assert_array_equal(g, [[1, 1, 0], [1, 1, 0], [0, 0, 0]])


def test_nhwc_conv_and_pool_make_no_layout_copy():
    """The channel-last path hands torch channels-last views and gets
    an NHWC-contiguous output back: the NCHW-shaped view cuDNN sees has
    channels-last strides, and the result is a view of torch's output
    (no copy back to NHWC)."""
    x = torch.from_numpy(_t(X4))
    w = torch.from_numpy(W4).contiguous(memory_format=torch.channels_last)
    seen = {}
    conv = torch.nn.functional.conv2d

    def spy(a, *args, **kw):
        seen["in"] = a
        out = conv(a, *args, **kw)
        seen["out"] = out
        return out
    from paddle_tpu_torch.nn.functional import conv as tconv
    tconv._CONV[2] = spy
    try:
        y = tpaddle.nn.functional.conv2d(x, w, padding=1, data_format="NHWC")
    finally:
        tconv._CONV[2] = conv
    assert seen["in"].data_ptr() == x.data_ptr()
    assert seen["in"].is_contiguous(memory_format=torch.channels_last)
    assert y.is_contiguous() and y.data_ptr() == seen["out"].data_ptr()
    p = tpaddle.nn.functional.max_pool2d(y, 3, 2, 1, data_format="NHWC")
    assert p.is_contiguous() and list(p.shape) == [2, 4, 4, 6]


def test_mixed_dtype_conv_computes_in_f32():
    outs = []
    for P in (tpaddle, jpaddle):
        wt = P.to_tensor(W4).astype("bfloat16")
        o = P.nn.functional.conv2d(P.to_tensor(X4), wt, padding=1)
        assert "float32" in str(o.dtype)
        outs.append(np.asarray(o.numpy()))
    _close(outs[0], outs[1], "mixed")


def test_transposed_conv_refuses_string_padding_as_jax_does():
    w = _f(4, 2, 3, 3)
    for P in (tpaddle, jpaddle):
        with pytest.raises(ValueError):
            P.nn.functional.conv2d_transpose(P.to_tensor(X4),
                                             P.to_tensor(w), stride=2,
                                             padding="SAME")


def test_return_mask_and_unpool_match_jax():
    x = _f(2, 3, 7, 6)
    res = []
    for P in (tpaddle, jpaddle):
        t = P.to_tensor(x, stop_gradient=False)
        out, mask = P.nn.functional.max_pool2d(t, 3, 2, 1, return_mask=True,
                                               ceil_mode=True)
        up = P.nn.functional.max_unpool2d(out, mask, 3, 2, 1,
                                          output_size=[7, 6])
        up.sum().backward()
        res.append([np.asarray(v.numpy()) for v in (out, mask, up, t.grad)])
    for i, (g, j) in enumerate(zip(*res)):
        _close(g, j, f"mask path {i}")
    with pytest.raises(ValueError):
        tpaddle.nn.functional.max_pool2d(tpaddle.to_tensor(_t(x)), 2,
                                         return_mask=True,
                                         data_format="NHWC")


def test_fractional_pool_draws_u_on_the_host_from_the_port_generator():
    from paddle_tpu_torch.core import random as trandom
    x = tpaddle.to_tensor(_f(1, 2, 9, 9))
    tpaddle.seed(3)
    d0 = trandom.draws()
    a, ma = tpaddle.nn.functional.fractional_max_pool2d(x, 4,
                                                        return_mask=True)
    assert trandom.draws() == d0 + 1
    tpaddle.seed(3)
    b = tpaddle.nn.functional.fractional_max_pool2d(x, 4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert list(a.shape) == [1, 2, 4, 4] and ma.dtype == torch.int32
    with pytest.raises(ValueError):
        tpaddle.nn.functional.fractional_max_pool2d(x, 4, random_u=1.5)


LAYERS = [
    ("Conv2D", (4, 6, 3), {"padding": "SAME", "data_format": "NHWC",
                           "groups": 2}, _t(X4)),
    ("Conv1D", (4, 5, 3), {}, X3),
    ("Conv3D", (3, 2, 2), {"bias_attr": False}, X5),
    ("Conv2DTranspose", (4, 3, 3), {"stride": 2, "padding": 1}, X4),
    ("MaxPool2D", (3, 2, 1), {"data_format": "NHWC"}, _t(R4)),
    ("AvgPool2D", (2,), {"ceil_mode": True}, R4b),
    ("MaxPool1D", (2,), {}, X3),
    ("AvgPool1D", (3, 1, 1), {}, X3),
    ("MaxPool3D", (2,), {}, X5),
    ("AvgPool3D", (2,), {}, X5),
    ("AdaptiveAvgPool2D", ((1, 1), "NHWC"), {}, _t(R4)),
    ("AdaptiveAvgPool1D", (3,), {}, X3),
    ("AdaptiveAvgPool3D", (2,), {}, X5),
    ("AdaptiveMaxPool2D", (3,), {}, R4b),
    ("AdaptiveMaxPool1D", (3,), {}, X3),
    ("AdaptiveMaxPool3D", (2,), {}, X5),
]


@pytest.mark.parametrize("cls,args,kw,x", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_jax(cls, args, kw, x):
    jl = getattr(jpaddle.nn, cls)(*args, **kw)
    tl = getattr(tpaddle.nn, cls)(*args, **kw)
    jsd = {k: np.asarray(v._data) for k, v in jl.state_dict().items()}
    assert set(jsd) == set(tl.state_dict())
    for k, v in tl.state_dict().items():
        assert list(v.shape) == list(jsd[k].shape), k
    tl.set_state_dict(jsd)
    got = tl(tpaddle.to_tensor(x)).numpy()
    _close(got, np.asarray(jl(jpaddle.to_tensor(x)).numpy()), cls)


def test_nhwc_conv2d_layer_keeps_a_channels_last_weight():
    layer = tpaddle.nn.Conv2D(4, 6, 3, data_format="NHWC")
    w = layer._parameters["weight"]
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert list(w.shape) == [6, 4, 3, 3]
    layer.set_state_dict({"weight": W4, "bias": B6})
    assert w.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(w.detach().numpy(), W4)
    layer.bfloat16()
    assert layer._parameters["weight"].is_contiguous(
        memory_format=torch.channels_last)


# the op rows the port still lacks after the vision slice and the op
# surface's tail (ROADMAP queue 1): ring_attention, with the distributed
# package; a ported row falling back would show here
UNPORTED_AFTER_VISION = ["ring_attention"]


def test_unported_lists_exactly_the_rows_left():
    from paddle_tpu_torch.ops import op_registry
    assert op_registry.unported() == UNPORTED_AFTER_VISION
    for name in ("conv2d", "conv2d_transpose", "max_pool2d",
                 "adaptive_avg_pool2d", "batch_norm", "group_norm",
                 "instance_norm", "local_response_norm", "interpolate",
                 "upsample", "pixel_shuffle", "fold", "dropout2d",
                 "alpha_dropout"):
        assert op_registry.resolve(name) is getattr(
            tpaddle.nn.functional, name), name

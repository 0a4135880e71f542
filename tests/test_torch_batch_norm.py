"""The port's batch, group, instance and local-response norms against the
JAX package's, on the CPU.

The JAX side runs as one jitted ``value_and_grad`` over the JAX
functional, its running statistics carried out of the trace. Batch norm
in training is the JAX package's one-pass anchored statistics with the
closed-form backward: output, ``dx``, ``dweight``, ``dbias`` and the
running statistics within ``TOL · (1 + |ref|)``, TOL = 2e-5 (f32 on both
sides, reductions added in other orders). bf16 running statistics
(a ``bfloat16()`` layer) agree within one bf16 rounding of 1 + |ref|
(2⁻⁸): both round every update to bf16, but XLA may keep the
product of an update in f32 before the add. The cold-anchor repair
(a mean far from the anchor) is held at batch 4 (the exact variance
over the whole batch) and at batch 16 (over the rows ``x[::2]``, the
same rows as JAX's); there the affine cancels ``x·scale ≈ 300``
against the shift, so the output and ``dx`` are held to 2e-4 absolute
(a few f32 roundings of 300), ``dweight`` to 2e-3. Batch norm makes no host read: no
``aten._local_scalar_dense`` (``.item()``, ``bool()``) runs in its
forward or backward, so a CUDA graph can hold it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 2e-5
BF16_TOL = 2.0 ** -8

_R = np.random.default_rng(5)


def _f(*shape, scale=1.0, shift=0.0):
    return (_R.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _np(a):
    return np.asarray(a, np.float32) if a.dtype.name == "bfloat16" \
        else np.asarray(a)


def _jax_bn(x, w, b, rm, rv, g, **kw):
    """JAX ``batch_norm`` as one jitted value_and_grad: (out, dx, dw, db,
    new running mean, new running var)."""
    def loss(x, w, b, rm, rv):
        T = jpaddle.Tensor
        rmt, rvt = T(rm), T(rv)
        out = jpaddle.nn.functional.batch_norm(T(x), rmt, rvt, T(w), T(b),
                                               **kw)._data
        return jnp.sum(out.astype(jnp.float32) * g), \
            (out, rmt._data, rvt._data)

    (_, (out, rm2, rv2)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, w, b, rm, rv)
    return [_np(v) for v in (out, *grads, rm2, rv2)]


def _port_bn(x, w, b, rm, rv, g, dtype=torch.float32, **kw):
    ts = [tpaddle.to_tensor(a, stop_gradient=False).astype(dtype)
          for a in (x, w, b)]
    for t in ts:
        t.stop_gradient = False
        t._t.retain_grad()
    rmt = tpaddle.to_tensor(rm).astype(dtype)
    rvt = tpaddle.to_tensor(rv).astype(dtype)
    out = tpaddle.nn.functional.batch_norm(ts[0], rmt, rvt, ts[1], ts[2],
                                           **kw)
    (out.astype("float32") * tpaddle.to_tensor(g)).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in ts] + \
        [rmt.numpy(), rvt.numpy()]


def _case(x, layout, momentum=0.9, anchor=0.0):
    c = x.shape[1] if layout == "NCHW" else x.shape[-1]
    w, b = _f(c, shift=1.0), _f(c)
    rm = np.full(c, anchor, np.float32) + _f(c, scale=0.1)
    rv = np.abs(_f(c)) + 0.5
    g = _f(*x.shape)
    return x, w, b, rm, rv, g, dict(training=True, momentum=momentum,
                                    data_format=layout)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (6, 5)],
                         ids=["4d", "2d"])
def test_train_forward_and_closed_form_gradient_match_jax(layout, shape):
    x = _f(*shape, scale=2.0, shift=0.5)
    if layout == "NHWC" and len(shape) == 4:
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    lay = layout if len(shape) == 4 else "NCHW"
    *args, kw = _case(x, lay)
    got = _port_bn(*args, **kw)
    want = _jax_bn(*args, **kw)
    for name, g, j in zip(("out", "dx", "dw", "db", "mean", "var"), got,
                          want):
        _close(g, j, name)


@pytest.mark.parametrize("batch,expect_stride", [(4, 1), (16, 2)])
def test_cold_anchor_repair_matches_jax_on_the_sampled_rows(batch,
                                                            expect_stride):
    """Mean 300 against an anchor at 0: the one-pass variance cancels,
    so both packages take the exact-centred variance over the rows
    ``x[::max(1, N // 8)]``."""
    x = _f(batch, 3, 4, 4, shift=300.0)
    x[:, 1] = _f(batch, 4, 4)          # one healthy channel
    *args, kw = _case(x, "NCHW")
    args[3] = np.zeros(3, np.float32)
    got = _port_bn(*args, **kw)
    want = _jax_bn(*args, **kw)
    # the affine cancels x·scale ≈ 300 against the shift: the output and
    # dx are held to a few f32 roundings of 300 (absolute); dw = inv ·
    # (Σg·x − m·Σg) cancels terms of 300 · Σ|g| ≈ 2e4, so 2e-3 absolute
    for name, g, j, atol in zip(("out", "dx", "dw", "db", "mean", "var"),
                                got, want, (2e-4, 2e-4, 2e-3, 0, 0, 0)):
        if atol:
            np.testing.assert_allclose(g, j, atol=atol, rtol=0, err_msg=name)
        else:
            _close(g, j, name)
    # the variance is the sampled rows', not the whole batch's
    xs = x[::expect_stride].astype(np.float64)
    m = x.astype(np.float64).mean(axis=(0, 2, 3))
    n = x.size // 3
    v_rows = ((xs - m[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    rv_want = 0.9 * args[4] + 0.1 * v_rows * n / (n - 1)
    np.testing.assert_allclose(got[5], rv_want, rtol=1e-4)


def test_running_stats_after_three_steps_f32_and_bf16_buffers():
    results = {}
    xs = [_f(6, 3, 3, 4, scale=1.5, shift=2.0 + step) for step in range(3)]
    for dtype in ("float32", "bfloat16"):
        outs = []
        for P in (tpaddle, jpaddle):
            bn = P.nn.BatchNorm2D(4, momentum=0.8, data_format="NHWC")
            if dtype == "bfloat16":
                bn.bfloat16()
            for x in xs:
                bn(P.to_tensor(x).astype(dtype))
            outs.append([_np(np.asarray(bn._mean.numpy())),
                         _np(np.asarray(bn._variance.numpy())),
                         str(bn._mean.dtype)])
        results[dtype] = outs
        (tm, tv, tdt), (jm, jv, jdt) = outs
        assert dtype in tdt and dtype in jdt
        tol = TOL if dtype == "float32" else BF16_TOL
        _close(tm, jm, f"{dtype} mean", tol)
        _close(tv, jv, f"{dtype} var", tol)
    assert not np.array_equal(results["float32"][0][0],
                              results["bfloat16"][0][0])


@pytest.mark.parametrize("mode", ["eval", "global_stats"])
def test_eval_and_use_global_stats_take_the_running_stats(mode):
    x = _f(5, 3, 4, 4, shift=1.0)
    x, w, b, rm, rv, g, kw = _case(x, "NCHW")
    kw = dict(training=mode == "global_stats",
              use_global_stats=True if mode == "global_stats" else None)
    got = _port_bn(x, w, b, rm, rv, g, **kw)
    want = _jax_bn(x, w, b, rm, rv, g, **kw)
    for name, gg, j in zip(("out", "dx", "dw", "db", "mean", "var"), got,
                           want):
        _close(gg, j, name)
    np.testing.assert_array_equal(got[4], rm)


def test_non_tensor_running_mean_anchors_at_zero():
    x = _f(4, 3, shift=0.5)
    outs = []
    for P in (tpaddle, jpaddle):
        outs.append(P.nn.functional.batch_norm(
            P.to_tensor(x), np.zeros(3, np.float32), np.ones(3, np.float32),
            training=True).numpy())
    _close(outs[0], outs[1], "out")


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func is not torch.ops.aten._local_scalar_dense.default, \
            "batch_norm read a device value on the host"
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("batch", [4, 16])
def test_batch_norm_makes_no_host_read(batch):
    """Forward (repair branch included: a cold anchor) and backward
    without ``.item()`` or ``bool()`` of a tensor."""
    bn = tpaddle.nn.BatchNorm2D(3, data_format="NHWC")
    x = torch.from_numpy(_f(batch, 4, 4, 3, shift=500.0)).requires_grad_()
    with _NoHostRead():
        y = bn(x)
        y.square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert bn._mean.abs().max() > 10      # the running stats moved


def test_running_stats_are_updated_in_place():
    bn = tpaddle.nn.BatchNorm2D(3)
    ptrs = [bn._buffers[k].data_ptr() for k in ("_mean", "_variance")]
    bn(tpaddle.to_tensor(_f(4, 3, 2, 2)))
    bn.bfloat16()
    ptrs = [bn._buffers[k].data_ptr() for k in ("_mean", "_variance")]
    before = bn._buffers["_mean"].clone()
    bn(tpaddle.to_tensor(_f(4, 3, 2, 2, shift=3.0)).astype("bfloat16"))
    assert [bn._buffers[k].data_ptr() for k in ("_mean", "_variance")] \
        == ptrs
    assert bn._buffers["_mean"].dtype == torch.bfloat16
    assert not torch.equal(before, bn._buffers["_mean"])


NORMS = [
    ("group_norm", lambda P, x, w, b: P.nn.functional.group_norm(
        x, 2, w, b), [_f(3, 4, 5, 2), _f(4), _f(4)]),
    ("group_norm_nhwc", lambda P, x, w, b: P.nn.functional.group_norm(
        x, 3, w, b, data_format="NHWC"), [_f(2, 3, 4, 6), _f(6), _f(6)]),
    ("instance_norm", lambda P, x, w, b: P.nn.functional.instance_norm(
        x, weight=w, bias=b), [_f(2, 3, 4, 5), _f(3), _f(3)]),
    ("instance_norm_1d", lambda P, x: P.nn.functional.instance_norm(x),
     [_f(2, 3, 7)]),
    ("local_response_norm", lambda P, x:
     P.nn.functional.local_response_norm(x, 3), [_f(2, 5, 3, 3)]),
    ("local_response_norm_nhwc", lambda P, x:
     P.nn.functional.local_response_norm(x, 4, 1e-2, 0.5, 2.0,
                                         data_format="NHWC"),
     [_f(2, 3, 3, 6)]),
]


@pytest.mark.parametrize("name,fn,arrays", NORMS, ids=[n[0] for n in NORMS])
def test_norm_matches_jax_forward_and_gradient(name, fn, arrays):
    ts = [tpaddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(tpaddle, *ts)
    g = _f(*out.shape)
    (out * tpaddle.to_tensor(g)).sum().backward()

    def loss(*arrs):
        o = fn(jpaddle, *[jpaddle.Tensor(a) for a in arrs])._data
        return jnp.sum(o * g), o

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True))(*arrays)
    _close(out.numpy(), want, name)
    for i, (t, j) in enumerate(zip(ts, grads)):
        _close(t.grad.numpy(), j, f"{name} grad {i}")


LAYERS = [
    ("BatchNorm1D", (3,), _f(5, 3)),
    ("BatchNorm3D", (2,), _f(3, 2, 2, 3, 2)),
    ("BatchNorm", (3,), _f(4, 3, 2, 2)),
    ("GroupNorm", (2, 4), _f(2, 4, 3, 3)),
    ("InstanceNorm2D", (3,), _f(2, 3, 4, 4)),
    ("LocalResponseNorm", (3,), _f(2, 4, 2, 2)),
]


@pytest.mark.parametrize("cls,args,x", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(cls, args, x):
    jl = getattr(jpaddle.nn, cls)(*args)
    tl = getattr(tpaddle.nn, cls)(*args)
    jsd = {k: _np(np.asarray(v._data)) for k, v in jl.state_dict().items()}
    assert set(jsd) == set(tl.state_dict())
    tl.set_state_dict(jsd)
    _close(tl(tpaddle.to_tensor(x)).numpy(),
           jl(jpaddle.to_tensor(x)).numpy(), cls)
    tsd = tl.state_dict()
    for k, v in jl.state_dict().items():
        _close(tsd[k].numpy(), _np(np.asarray(v._data)), f"{cls}.{k}")


def test_spectral_norm_matches_jax():
    jl = jpaddle.nn.SpectralNorm([4, 3], power_iters=2)
    tl = tpaddle.nn.SpectralNorm([4, 3], power_iters=2)
    tl.set_state_dict({k: np.asarray(v._data)
                       for k, v in jl.state_dict().items()})
    w = _f(4, 3)
    _close(tl(tpaddle.to_tensor(w)).numpy(),
           jl(jpaddle.to_tensor(w)).numpy(), "spectral")


def test_convert_sync_batchnorm_keeps_parameters_and_buffers():
    net = tpaddle.nn.Sequential(tpaddle.nn.Conv2D(3, 4, 1),
                                tpaddle.nn.BatchNorm2D(4))
    bn = net[1]
    out = tpaddle.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net and isinstance(net[1], tpaddle.nn.SyncBatchNorm)
    assert net[1]._parameters["weight"] is bn._parameters["weight"]
    assert net[1]._buffers["_mean"] is bn._buffers["_mean"]
    net(tpaddle.to_tensor(_f(2, 3, 2, 2)))
    assert bn._buffers["_mean"].abs().sum() > 0

"""The port's autograd core against the JAX package's, on the CPU:
``PyLayer`` (outputs and gradients, several inputs and outputs, a None
gradient, a non-float input, ``set_materialize_grads``),
``saved_tensors_hooks`` (only ``save_for_backward``'s tensors, unpacked
once), ``jacobian`` / ``hessian`` / ``vjp`` / ``jvp`` with each nesting
rule within 1e-5, the ``FLAGS_check_nan_inf`` scan at stride 1 and 4
(the same op named as JAX's, the queue drained at ``backward``),
``FLAGS_retain_grad_for_all_tensor`` and ``FLAGS_benchmark``.
(``tests/test_torch_imports.py`` checks that ``paddle_tpu_torch.autograd``,
``geometric`` and ``incubate`` import without JAX.)
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core import autograd as jag
from paddle_tpu_torch.core import autograd as tag
from test_torch_tensor import port_on_cpu  # noqa: F401

TOL = 1e-5


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x.numpy(), np.float64)


def _same(got, want, tol=TOL, what=""):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), \
            (what, type(got), len(got) if isinstance(got, (tuple, list))
             else None, len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{what}[{i}]")
        return
    assert not isinstance(got, (tuple, list)), (what, type(got))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.all(np.abs(g - w) <= tol * (1 + np.abs(w))), \
        (what, float(np.abs(g - w).max()))


def _layers(P):
    """The same PyLayer classes over package ``P``."""

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x

    class AddMul(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a + b, a * b

        @staticmethod
        def backward(ctx, da, dm):
            a, b = ctx.saved_tensor()
            return da + dm * b, da + dm * a

    class NoneGrad(P.autograd.PyLayer):
        """The second input's gradient is None (becomes zeros)."""
        @staticmethod
        def forward(ctx, a, b):
            return a * 2 + b

        @staticmethod
        def backward(ctx, dy):
            return dy * 2, None

    class IntArg(P.autograd.PyLayer):
        """A non-float Tensor input (its gradient is dropped) and a
        Python scalar argument."""
        @staticmethod
        def forward(ctx, x, idx, scale):
            ctx.save_for_backward(x)
            return P.sin(x) * scale + P.cast(idx, x.dtype)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * P.cos(x) * 3.0, dy * 0

    class Unmaterialized(P.autograd.PyLayer):
        """Two outputs, only the first used; set_materialize_grads(False)
        (the JAX layer materialises them all the same)."""
        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            ctx.mark_not_inplace(x)
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, d1, d2):
            return d1 * 2 + d2 * 3

    return dict(Cube=Cube, AddMul=AddMul, NoneGrad=NoneGrad, IntArg=IntArg,
                Unmaterialized=Unmaterialized)


def _run_layer(P, name, vals):
    L = _layers(P)[name]
    a = P.to_tensor(vals[0], stop_gradient=False)
    if name == "Cube":
        outs = [L.apply(a)]
        ins = [a]
    elif name == "IntArg":
        idx = P.to_tensor(np.array([1, 2, 3], np.int64))
        outs = [L.apply(a, idx, 3.0)]
        ins = [a]
    elif name == "Unmaterialized":
        outs = list(L.apply(a))[:1]
        ins = [a]
    else:
        b = P.to_tensor(vals[1], stop_gradient=False)
        res = L.apply(a, b)
        outs = list(res) if isinstance(res, (tuple, list)) else [res]
        ins = [a, b]
    w = [P.to_tensor(np.linspace(0.5, 1.5, o.size).reshape(o.shape)
                     .astype(np.float32)) for o in outs]
    loss = sum((o * wi).sum() for o, wi in zip(outs, w))
    loss.backward()
    return [o.numpy() for o in outs], [i.grad.numpy() for i in ins]


@pytest.mark.parametrize("name", ["Cube", "AddMul", "NoneGrad", "IntArg",
                                  "Unmaterialized"])
def test_py_layer_matches_jax(name):
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(3).astype(np.float32) for _ in range(2)]
    jo, jg = _run_layer(jpaddle, name, vals)
    to, tg = _run_layer(tpaddle, name, vals)
    for a, b in zip(to + tg, jo + jg):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_py_layer_without_gradients_returns_the_outputs():
    L = _layers(tpaddle)["AddMul"]
    a = tpaddle.to_tensor([1.0, 2.0])
    b = tpaddle.to_tensor([3.0, 4.0])
    s, m = L.apply(a, b)
    assert s.stop_gradient and m.stop_gradient
    np.testing.assert_array_equal(m.numpy(), [3.0, 8.0])
    x = tpaddle.to_tensor([1.0], stop_gradient=False)
    with tpaddle.no_grad():
        y = _layers(tpaddle)["Cube"].apply(x)
    assert y.stop_gradient


def test_py_layer_counts_its_node_by_name():
    L = _layers(tpaddle)["Cube"]
    before = tag._dispatches.get("Cube", 0)
    L.apply(tpaddle.to_tensor([2.0], stop_gradient=False))
    assert tag._dispatches["Cube"] == before + 1
    node = tag.GradNode(None, (), (), "Cube")
    assert repr(node) == "GradNode(Cube)" and node.name == "Cube"
    assert node.inputs == node.out_avals == () and node.vjp_fn is None


def test_saved_tensors_hooks_reach_save_for_backward_only():
    """Pack runs once a saved tensor at save time, unpack once at the
    first ``saved_tensor()``; the ops inside and around the PyLayer (a
    multiply saves its inputs in torch) reach neither hook."""
    packed, unpacked = [], []

    class Twice(tpaddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            (x2,) = ctx.saved_tensor()     # a second read: no unpack
            assert x2 is x
            return dy * 2 * x

    def pack(t):
        packed.append(t)
        return ("host", t.numpy())

    def unpack(p):
        unpacked.append(p)
        return tpaddle.to_tensor(p[1])

    x = tpaddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    with tpaddle.autograd.saved_tensors_hooks(pack, unpack):
        y = (Twice.apply(x * 1.5) * x).sum()
    assert len(packed) == 1 and not unpacked
    y.backward()
    assert len(unpacked) == 1
    want = 2 * (1.5 * np.array([1, 2, 3.])) * 1.5 * np.array([1, 2, 3.]) \
        + (1.5 * np.array([1, 2, 3.])) ** 2
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6)


def _fns(P):
    return {
        "square": lambda t: t * t,
        "sin_sum": lambda t: (P.sin(t) * t).sum(),
        "two_in": lambda a, b: P.sin(a) * b + a * a,
        "two_out": lambda a, b: (a * b, P.exp(a) + b),
        "cubic": lambda a, b: (a * a * b + P.sin(b) * a).sum(),
    }


def _x(P, n=3, seed=1):
    r = np.random.default_rng(seed)
    return P.to_tensor(r.standard_normal(n).astype(np.float32))


def _both(call):
    return (call(jpaddle, jpaddle.autograd),
            call(tpaddle, tpaddle.autograd))


JAC_CASES = {
    # a single Tensor: the Jacobian itself (jac[0])
    "single": lambda P, A: A.jacobian(_fns(P)["square"], _x(P)),
    # a one-tuple: a tuple of one
    "tuple_of_one": lambda P, A: A.jacobian(_fns(P)["square"], (_x(P),)),
    "two_inputs": lambda P, A: A.jacobian(_fns(P)["two_in"],
                                          (_x(P), _x(P, seed=2))),
    "two_outputs": lambda P, A: A.jacobian(_fns(P)["two_out"],
                                           [_x(P), _x(P, seed=2)]),
    "hessian_single": lambda P, A: A.hessian(_fns(P)["sin_sum"], _x(P)),
    "hessian_two": lambda P, A: A.hessian(_fns(P)["cubic"],
                                          (_x(P), _x(P, seed=2))),
    "vjp_ones": lambda P, A: A.vjp(_fns(P)["square"], _x(P)),
    "vjp_v": lambda P, A: A.vjp(_fns(P)["two_in"],
                                (_x(P), _x(P, seed=2)), _x(P, seed=3)),
    "jvp_ones": lambda P, A: A.jvp(_fns(P)["sin_sum"], _x(P)),
    "jvp_v": lambda P, A: A.jvp(_fns(P)["two_in"],
                                (_x(P), _x(P, seed=2)),
                                (_x(P, seed=3), _x(P, seed=4))),
}


@pytest.mark.parametrize("case", sorted(JAC_CASES))
def test_functional_matches_jax(case):
    want, got = _both(lambda P, A: JAC_CASES[case](P, A))
    _same(got, want, what=case)


def _nan_flags(P, stride):
    P.set_flags({"FLAGS_check_nan_inf": True,
                 "FLAGS_check_nan_inf_stride": stride})


def _nan_off(P, ag):
    P.set_flags({"FLAGS_check_nan_inf": False,
                 "FLAGS_check_nan_inf_stride": 1})
    ag._nan_pending.clear()


def _nan_chain(P):
    x = P.to_tensor(np.array([1.0, 0.0], np.float32))
    a = x * 2.0
    b = x / x
    c = a + 1.0
    return c * 3.0 + b


@pytest.mark.parametrize("stride", [1, 4])
def test_nan_check_names_the_op_as_jax_does(stride):
    msgs = []
    for P, ag in ((jpaddle, jag), (tpaddle, tag)):
        _nan_flags(P, stride)
        try:
            with pytest.raises(FloatingPointError) as e:
                _nan_chain(P)
                ag.flush_nan_checks()
            msgs.append(str(e.value))
        finally:
            _nan_off(P, ag)
    assert msgs[0] == msgs[1]
    assert "Operator divide output 0 contains NaN or Inf" in msgs[1]


def test_nan_check_queues_and_fetches_once_a_stride():
    _nan_flags(tpaddle, 4)
    try:
        f0 = tag._nan_fetches
        x = tpaddle.to_tensor(np.array([1.0, 2.0], np.float32))
        y = x * 2.0
        y = y + 1.0
        y = y * y
        assert len(tag._nan_pending) == 3 and tag._nan_fetches == f0
        y = y - 1.0
        assert not tag._nan_pending and tag._nan_fetches == f0 + 1
        for _ in range(8):
            y = y * 1.0
        assert tag._nan_fetches == f0 + 3
    finally:
        _nan_off(tpaddle, tag)


def test_nan_queue_drains_at_backward_and_grad():
    for P, ag in ((jpaddle, jag), (tpaddle, tag)):
        _nan_flags(P, 64)
        try:
            x = P.to_tensor(np.array([0.0], np.float32), stop_gradient=False)
            y = (x / x).sum()
            assert ag._nan_pending
            with pytest.raises(FloatingPointError, match="divide"):
                y.backward()
        finally:
            _nan_off(P, ag)
    _nan_flags(tpaddle, 64)
    try:
        x = tpaddle.to_tensor([0.0], stop_gradient=False)
        y = (x / x).sum()
        with pytest.raises(FloatingPointError, match="divide"):
            tpaddle.grad(y, [x])
    finally:
        _nan_off(tpaddle, tag)


def test_nan_flush_keeps_its_queue_while_capturing(monkeypatch):
    """A flush inside a capture (here torch.compile's tracing stands in
    for a CUDA stream capture) fetches nothing and keeps the queue; the
    first backward after it drains the queue and raises."""
    _nan_flags(tpaddle, 64)
    try:
        x = tpaddle.to_tensor(np.array([0.0], np.float32),
                              stop_gradient=False)
        y = (x / x).sum()
        queued, f0 = len(tag._nan_pending), tag._nan_fetches
        assert queued
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        tag.flush_nan_checks()
        assert len(tag._nan_pending) == queued and tag._nan_fetches == f0
        monkeypatch.undo()
        with pytest.raises(FloatingPointError, match="divide"):
            y.backward()
        assert not tag._nan_pending and tag._nan_fetches == f0 + 1
    finally:
        _nan_off(tpaddle, tag)


def test_flags_set_the_one_checks_switch():
    assert not tag._checks_on
    for flag in ("FLAGS_check_nan_inf", "FLAGS_benchmark",
                 "FLAGS_retain_grad_for_all_tensor"):
        tpaddle.set_flags({flag: True})
        try:
            assert tag._checks_on, flag
        finally:
            tpaddle.set_flags({flag: False})
        assert not tag._checks_on, flag


def test_nan_check_off_by_default_and_skipped_under_a_recorder():
    x = tpaddle.to_tensor([0.0])
    assert np.isnan((x / x).numpy()).all()
    _nan_flags(tpaddle, 1)
    prev = tag._op_recorder
    tag._op_recorder = lambda *a: None
    try:
        assert np.isnan((x / x).numpy()).all()    # recorded: not scanned
    finally:
        tag._op_recorder = prev
        _nan_off(tpaddle, tag)


def test_retain_grad_for_all_tensor_matches_jax():
    got = []
    for P in (jpaddle, tpaddle):
        P.set_flags({"FLAGS_retain_grad_for_all_tensor": True})
        try:
            x = P.to_tensor(np.array([1.0, 2.0], np.float32),
                            stop_gradient=False)
            y = x * 3.0
            z = (y * y).sum()
            z.backward()
            got.append(y.grad.numpy())
        finally:
            P.set_flags({"FLAGS_retain_grad_for_all_tensor": False})
    np.testing.assert_allclose(got[1], got[0], rtol=TOL)
    x = tpaddle.to_tensor([1.0], stop_gradient=False)
    y = x * 3.0
    (y * y).sum().backward()
    assert y.grad is None                  # off: interior grads dropped


def test_benchmark_flag_runs_each_op_synchronised():
    tpaddle.set_flags({"FLAGS_benchmark": True})
    try:
        x = tpaddle.to_tensor([1.0, 2.0])
        np.testing.assert_array_equal((x * 2).numpy(), [2.0, 4.0])
    finally:
        tpaddle.set_flags({"FLAGS_benchmark": False})
    assert tpaddle.get_flags("FLAGS_benchmark") == \
        {"FLAGS_benchmark": False}

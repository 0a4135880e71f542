"""The port's SOT dy2static (``paddle_tpu_torch.jit.sot``) against the
JAX package's (``paddle_tpu.jit.sot``), on the CPU.

Each case of ``tests/test_sot.py`` is written once against a "side" (a
package with its ``nn``, ``functional`` and ``jit.sot``) and run through
both: the same numpy inputs, weights set from one numpy generator by
parameter name, the same calls. The observations compared: every result
(within 1e-6 + 1e-6·|ref| in f32; the AMP case within one bf16 rounding),
how often the user's Python ran, ``cache_size()`` and the fallback
categories of the recordings that stayed eager. On the CPU the port
replays every path op by op (CUDA graphs are the card's: those run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). The speculative
case runs once more with the NaN-check flags (``FLAGS_check_nan_inf``
at strides 1 and 4): no flag of a discarded speculation may be left in
the queue, and the flush must not raise. The capture planner
(``analysis.capture_plan``) attaches an SOT function's segment
metadata on both sides. The last tests are the port's own: a
computation ``apply_op`` never saw (a plain torch module) must not
replay.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.jit import sot as jsot
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.jit import sot as tsot
from test_torch_tensor import port_on_cpu  # noqa: F401

ATOL = RTOL = 1e-6


class Side:
    def __init__(self, name, paddle, sot):
        self.name, self.P, self.sot = name, paddle, sot
        self.nn, self.F = paddle.nn, paddle.nn.functional
        self.SOT = sot.SOTFunction

    def t(self, a):
        return self.P.to_tensor(np.asarray(a))

    def init(self, layer, seed=0):
        """Every parameter from one numpy generator, by name."""
        rng = np.random.default_rng(seed)
        for _, p in sorted(layer.named_parameters(), key=lambda kv: kv[0]):
            p.set_value((rng.standard_normal(p.shape) * 0.5)
                        .astype(np.float32))
        return layer


SIDES = [Side("jax", jpaddle, jsot), Side("port", tpaddle, tsot)]


def _np(x):
    if x is None:
        return None
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def _categories(S, sf):
    return sorted({S.sot._fallback_category(r)
                   for r in sf._fallback_reasons})


def _run(case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [case(S) for S in SIDES]


def _same(case, atol=ATOL, rtol=RTOL):
    """Run ``case`` on both sides and compare what it observed."""
    j, t = _run(case)
    assert set(j) == set(t)
    for key in j:
        if key == "values":
            assert len(j[key]) == len(t[key])
            for a, b in zip(j[key], t[key]):
                np.testing.assert_allclose(_np(b), _np(a), atol=atol,
                                           rtol=rtol)
        else:
            assert j[key] == t[key], (key, j[key], t[key])
    return j, t


# -- record and replay -------------------------------------------------------

def case_branch_guards(S):
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        y = x * 2
        if (y.sum() > 0):
            return (y + 1) * 3
        return (y - 1) * 3

    sf = S.SOT(f)
    xp, xn = S.t(np.ones((2, 2), np.float32)), S.t(-np.ones((2, 2),
                                                            np.float32))
    vals = [sf(xp)]
    n1 = calls["n"]
    vals.append(sf(xp))
    n2 = calls["n"]
    vals.append(sf(xn))
    n3 = calls["n"]
    vals += [sf(xn), sf(xp)]
    return {"values": vals, "calls": [n1, n2, n3, calls["n"]],
            "cache": sf.cache_size()}


def case_mlp_control_flow(S):
    net = S.init(S.nn.Sequential(S.nn.Linear(8, 16), S.nn.Tanh(),
                                 S.nn.Linear(16, 4)))

    def f(x):
        h = net(x)
        if (h.mean() > 0):
            return S.F.softmax(h, axis=-1)
        return S.F.sigmoid(h)

    sf = S.SOT(f)
    rng = np.random.default_rng(1)
    vals = []
    for _ in range(3):
        x = S.t(rng.standard_normal((4, 8)).astype(np.float32))
        vals += [sf(x), f(x)]
    return {"values": vals, "cache": sf.cache_size()}


def case_while_loop(S):
    def g(x):
        s = x.sum()
        while (s < 10):
            s = s * 2 + 1
        return s

    sg = S.SOT(g)
    vals = [sg(S.t(np.float32(v))) for v in (1.0, 9.0, 1.0, 9.0)]
    return {"values": vals, "cache": sg.cache_size()}


def case_live_parameter(S):
    lin = S.init(S.nn.Linear(4, 4))
    sf = S.SOT(lambda t: lin(t) + 0.0)
    x = S.t(np.random.default_rng(2).standard_normal((2, 4))
            .astype(np.float32))
    first = sf(x)
    lin.weight.set_value(np.zeros((4, 4), np.float32))
    return {"values": [first, sf(x), lin.bias], "cache": sf.cache_size()}


def case_ext_tensor_guard(S):
    flag = S.t(np.float32(1.0))

    def f(x):
        if (flag):
            return x + 1
        return x - 1

    sf = S.SOT(f)
    x = S.t(np.float32(0.0))
    vals = [sf(x), sf(x)]
    flag.set_value(np.float32(0.0))
    vals.append(sf(x))
    return {"values": vals, "cache": sf.cache_size()}


@pytest.mark.parametrize("case", [
    case_branch_guards, case_mlp_control_flow, case_while_loop,
    case_live_parameter, case_ext_tensor_guard],
    ids=lambda c: c.__name__[5:])
def test_record_replay(case):
    _same(case)


def test_replay_does_not_rerun_python():
    j, t = _same(case_branch_guards)
    assert t["calls"] == [1, 1, 2, 2] and t["cache"] == 2


# -- fallbacks ---------------------------------------------------------------

def case_rng(S):
    sf = S.SOT(lambda x: S.F.dropout(x, 0.5, training=True))
    x = S.t(np.ones((64,), np.float32))
    o1, o2 = sf(x), sf(x)
    return {"fresh_masks": not np.array_equal(o1.numpy(), o2.numpy()),
            "cache": sf.cache_size(), "fallbacks": _categories(S, sf)}


def case_mutation(S):
    def f(x):
        x[0] = 5.0
        return x * 2

    sf = S.SOT(f)
    return {"values": [sf(S.t(np.zeros(3, np.float32)))],
            "fallbacks": _categories(S, sf)}


def case_inner_backward(S):
    lin = S.init(S.nn.Linear(2, 2))

    def f(x):
        y = lin(x).sum()
        y.backward()
        return lin.weight.grad

    sf = S.SOT(f)
    g1 = sf(S.t(np.ones((1, 2), np.float32)))
    g1 = g1.numpy().copy()
    lin.clear_gradients()
    g2 = sf(S.t(np.ones((1, 2), np.float32)))
    return {"values": [g1, g2], "fallbacks": _categories(S, sf)}


def case_inplace_op(S):
    def f(x):
        x.add_(1.0)
        return x * 2

    sf = S.SOT(f)
    vals = [sf(S.t(np.zeros(3, np.float32))) for _ in range(2)]
    return {"values": vals, "fallbacks": _categories(S, sf)}


def case_inplace_activation(S):
    sf = S.SOT(lambda x: S.F.relu_(x * 1.0) + 1)
    vals = [sf(S.t(np.array([-2.0, 2.0], np.float32))) for _ in range(2)]
    return {"values": vals, "fallbacks": _categories(S, sf)}


@pytest.mark.parametrize("case", [
    case_rng, case_mutation, case_inner_backward, case_inplace_op,
    case_inplace_activation], ids=lambda c: c.__name__[5:])
def test_fallbacks(case):
    j, _ = _same(case)
    assert j["fallbacks"]


# -- metadata, cache, buckets ------------------------------------------------

def _metadata(md):
    return {"entries": md["cache_entries"],
            "paths": sorted(
                (p["kind"], len(p.get("guards", ())),
                 tuple(g["kind"] for g in p.get("guards", ())),
                 len(p.get("segments", ())) >= 2,
                 "multiply" in [o for s in p.get("segments", ())
                                for o in s["ops"]])
                for p in md["paths"])}


def case_metadata(S):
    def f(x):
        y = x * 2
        if (y.sum() > 0):
            return y + 1
        return y - 1

    sf = S.SOT(f)
    sf(S.t(np.ones((2, 2), np.float32)))
    sf(S.t(-np.ones((2, 2), np.float32)))
    md = sf.capture_metadata()
    return {"metadata": _metadata(md), "reasons": md["fallback_reasons"]}


def case_metadata_fallback(S):
    sf = S.SOT(lambda x: S.F.dropout(x, 0.5, training=True))
    sf(S.t(np.ones((8,), np.float32)))
    md = sf.capture_metadata()
    return {"metadata": _metadata(md), "fallbacks": _categories(S, sf),
            "rng_named": any("RNG" in r for r in md["fallback_reasons"])}


def case_lru(S):
    S.P.set_flags({"FLAGS_sot_cache_size": 4})
    try:
        sf = S.SOT(lambda t: t + 1)
        vals = [sf(S.t(np.ones((n,), np.float32))) for n in range(1, 10)]
        return {"values": vals, "cache": sf.cache_size()}
    finally:
        S.P.set_flags({"FLAGS_sot_cache_size": 64})


def case_buckets_pow2(S):
    bp = S.sot.BucketPolicy({0: {1: "pow2"}}, pad_value=0)
    sf = S.SOT(lambda t: (t * 2).sum(axis=1), bucket_policy=bp)
    vals = [sf(S.t(np.ones((2, n), np.float32)))
            for n in (3, 4, 5, 7, 6, 8, 5, 3)]
    return {"values": vals, "cache": sf.cache_size()}


def case_buckets_list(S):
    bp = S.sot.BucketPolicy({0: {0: [16, 32]}}, pad_value=-100)
    seen = []

    def f(t):
        seen.append(t.shape[0])
        return t.sum()

    sf = S.SOT(f, bucket_policy=bp)
    vals = [sf(S.t(np.zeros(10, np.float32))),
            sf(S.t(np.zeros(20, np.float32)))]
    return {"values": vals, "seen": seen}


@pytest.mark.parametrize("case", [
    case_metadata, case_metadata_fallback, case_lru, case_buckets_pow2,
    case_buckets_list], ids=lambda c: c.__name__[5:])
def test_metadata_and_cache(case):
    _same(case)


# -- to_static ---------------------------------------------------------------

def case_to_static_default(S):
    @S.P.jit.to_static
    def k(x):
        if (x.mean() > 0):
            return x * 10
        return x * -10

    return {"values": [k(S.t(np.float32(2.0))), k(S.t(np.float32(-2.0)))],
            "sot": isinstance(k, S.SOT)}


def case_full_graph(S):
    net = S.init(S.nn.Linear(4, 4))
    st = S.P.jit.to_static(net, full_graph=True)
    x = S.t(np.random.default_rng(3).standard_normal((2, 4))
            .astype(np.float32))
    return {"values": [st(x), st(x), net(x)]}


def case_layer_keeps_api(S):
    net = S.init(S.nn.Linear(3, 3))
    ret = S.P.jit.to_static(net)
    x = S.t(np.random.default_rng(4).standard_normal((2, 3))
            .astype(np.float32))
    return {"values": [net(x), net(x)], "same": ret is net,
            "params": len(net.parameters())}


def case_training_through_replay(S):
    net = S.init(S.nn.Linear(4, 1))
    opt = S.P.optimizer.SGD(learning_rate=0.05,
                            parameters=net.parameters())

    @S.P.jit.to_static
    def forward(x, y):
        out = net(x)
        if (out.mean() < 1e6):
            pred = S.P.tanh(out)
        else:
            pred = out
        return ((pred - y) ** 2).mean()

    rng = np.random.default_rng(5)
    x = S.t(rng.standard_normal((16, 4)).astype(np.float32))
    y = S.t((rng.standard_normal((16, 1)) * .1).astype(np.float32))
    losses, grads = [], []
    for _ in range(6):
        loss = forward(x, y)
        loss.backward()
        grads.append(net.weight.grad.numpy().copy())
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"values": losses + grads + [net.weight],
            "fell": losses[-1] < losses[0]}


def case_nested(S):
    inner = S.SOT(lambda x: x * 2)
    outer = S.SOT(lambda x: inner(x) + 1)
    vals = [inner(S.t(np.float32(3.0)))]
    vals += [outer(S.t(np.float32(v))) for v in (3.0, 5.0, 4.0)]
    return {"values": vals, "cache": outer.cache_size()}


def case_guard_on_input(S):
    def f(x):
        v = x.item()
        return x + v

    sf = S.SOT(f)
    vals = [sf(S.t(np.float32(v))) for v in (2.0, 2.0, 3.0)]
    return {"values": vals, "cache": sf.cache_size()}


def case_guard_on_earlier_segment(S):
    def f(x):
        c = x.sum()
        bool(c > 0)
        y = x * 2
        bool(c < 100)
        return y + c

    sf = S.SOT(f)
    xin = S.t(np.ones(3, np.float32))
    return {"values": [sf(xin), sf(xin)], "cache": sf.cache_size()}


def case_raw_array_literal(S):
    def f(x, mask):
        return (x * S.P.to_tensor(mask)).sum()

    sf = S.SOT(f)
    x = S.t(np.ones(2000, np.float32))
    m1 = np.zeros(2000, np.float32)
    m1[0] = 1
    m2 = np.zeros(2000, np.float32)
    m2[1:3] = 1
    return {"values": [sf(x, m1), sf(x, m2), sf(x, m1)],
            "cache": sf.cache_size()}


@pytest.mark.parametrize("case", [
    case_to_static_default, case_full_graph, case_layer_keeps_api,
    case_training_through_replay, case_nested, case_guard_on_input,
    case_guard_on_earlier_segment, case_raw_array_literal],
    ids=lambda c: c.__name__[5:])
def test_to_static_and_guards(case):
    _same(case, atol=1e-5 if case is case_training_through_replay
          else ATOL)


# -- modes, AMP, numpy arguments ---------------------------------------------

def case_train_eval_modes(S):
    net = S.init(S.nn.Sequential(S.nn.Linear(8, 8), S.nn.Dropout(0.5)))
    sf = S.SOT(lambda t: net(t))
    x = S.t(np.ones((4, 8), np.float32))
    net.eval()
    e1, e2 = sf(x), sf(x)
    net.train()
    t1, t2 = sf(x), sf(x)
    net.eval()
    e3 = sf(x)
    return {"values": [e1, e2, e3],
            "train_differs": [not np.allclose(t1.numpy(), e1.numpy()),
                              not np.allclose(t1.numpy(), t2.numpy())],
            "cache": sf.cache_size(), "fallbacks": _categories(S, sf)}


def case_amp_replay(S):
    net = S.init(S.nn.Linear(16, 16))
    sf = S.SOT(lambda t: net(t))
    x = S.t(np.random.default_rng(6).standard_normal((4, 16))
            .astype(np.float32))
    with S.P.amp.auto_cast(level="O2"):
        a1, a2 = sf(x), sf(x)
    f1, f2 = sf(x), sf(x)
    return {"values": [a1, a2, f1, f2],
            "amp_equal": np.array_equal(a1.numpy(), a2.numpy()),
            "cache": sf.cache_size()}


def case_eager_branch_keeps_sibling(S):
    flag = S.t(np.float32(1.0))

    def f(x):
        if (flag):
            return x * 2
        return S.F.dropout(x, 0.5)

    sf = S.SOT(f)
    x = S.t(np.ones((8,), np.float32))
    r1 = sf(x)
    flag.set_value(np.float32(0.0))
    sf(x)
    flag.set_value(np.float32(1.0))
    before = sf.cache_size()
    r3 = sf(x)
    return {"values": [r1, r3], "cache": [before, sf.cache_size()],
            "fallbacks": _categories(S, sf)}


def case_mutated_numpy_arg(S):
    sf = S.SOT(lambda t, c: t * S.P.to_tensor(np.asarray(c)))
    x = S.t(np.full(4, 3.0, np.float32))
    buf = np.ones(4, np.float32)
    v1 = sf(x, buf)
    buf[:] = 2.0
    return {"values": [v1, sf(x, buf)], "cache": sf.cache_size()}


_GLOBAL_NET = {}


def case_global_layer_mode(S):
    _GLOBAL_NET[S.name] = S.init(S.nn.Sequential(S.nn.Linear(8, 8),
                                                 S.nn.Dropout(0.5)))

    def f(t):
        return _GLOBAL_NET[S.name](t)

    # the net is reached through a module global (a dict of them): its
    # mode joins the signature through the code's global names
    sf = S.SOT(f)
    x = S.t(np.ones((4, 8), np.float32))
    _GLOBAL_NET[S.name].eval()
    e1 = sf(x)
    _GLOBAL_NET[S.name].train()
    t1 = sf(x)
    return {"values": [e1], "differs": not np.allclose(t1.numpy(),
                                                       e1.numpy()),
            "cache": sf.cache_size()}


def case_amp_custom_lists(S):
    net = S.init(S.nn.Linear(16, 16))
    sf = S.SOT(lambda t: net(t))
    x = S.t(np.random.default_rng(7).standard_normal((2, 16))
            .astype(np.float32))
    with S.P.amp.auto_cast(level="O1"):
        sf(x)
    with S.P.amp.auto_cast(level="O1",
                           custom_black_list={"matmul", "linear"}):
        sf(x)
    return {"cache": sf.cache_size()}


def case_speculative_wrong_path(S):
    @S.sot.sot_compile
    def f(x):
        if bool((x.min() > 0).numpy()):
            return S.P.log(x)
        return x * 2.0

    pos = S.t(np.array([1.0, 2.0], np.float32))
    neg = S.t(np.array([-1.0, 2.0], np.float32))
    return {"values": [f(pos), f(pos), f(neg), f(neg)],
            "cache": f.cache_size()}


def case_speculative_nan_flags(S):
    """The speculative case under the NaN check: stride 1 raises at once,
    stride 4 queues; a discarded wrong-path speculation leaves no flag
    in the queue and the flush does not raise."""
    import importlib
    ag = importlib.import_module(S.P.__name__ + ".core.autograd")
    out = {"values": [], "leaked": []}
    for stride in (1, 4):
        S.P.set_flags({"FLAGS_check_nan_inf": True,
                       "FLAGS_check_nan_inf_stride": stride})
        try:
            @S.sot.sot_compile
            def f(x):
                if bool((x.min() > 0).numpy()):
                    return S.P.log(x)
                return x * 2.0

            pos = S.t(np.array([1.0, 2.0], np.float32))
            neg = S.t(np.array([-1.0, 2.0], np.float32))
            out["values"] += [f(pos), f(pos), f(neg), f(neg)]
            out["leaked"].append(any(np.asarray(fl).any()
                                     for _, _, fl in ag._nan_pending))
            ag.flush_nan_checks()
        finally:
            S.P.set_flags({"FLAGS_check_nan_inf": False,
                           "FLAGS_check_nan_inf_stride": 1})
    return out


@pytest.mark.parametrize("case", [
    case_train_eval_modes, case_eager_branch_keeps_sibling,
    case_mutated_numpy_arg, case_global_layer_mode, case_amp_custom_lists,
    case_speculative_wrong_path, case_speculative_nan_flags],
    ids=lambda c: c.__name__[5:])
def test_modes_and_signatures(case):
    j, t = _same(case)
    if "leaked" in t:
        assert t["leaked"] == [False, False]


def case_planner_metadata(S):
    import importlib
    analysis = importlib.import_module(S.P.__name__ + ".analysis")

    def f(x):
        return x * 2 + 1

    sf = S.SOT(f)
    sf(S.t(np.ones((4,), np.float32)))
    plan = analysis.capture_plan(sf, dynamic=False)
    return {"entries": plan.sot["cache_entries"],
            "rendered": "sot:" in plan.render(),
            "consistent": plan.consistent(),
            "breaks": [(b["reason"], b["classification"])
                       for b in plan.breaks]}


def test_planner_attaches_sot_metadata():
    """``analysis.capture_plan`` reads ``SOTFunction.capture_metadata``:
    one cache entry, rendered, nothing unaccounted, on both sides."""
    j, t = _same(case_planner_metadata)
    assert t["entries"] == 1 and t["rendered"] and t["consistent"]


def test_amp_replay_reproduces_autocast():
    # bf16 products: the two packages round the same operands, but their
    # matmuls may sum in another order, so one bf16 rounding apart
    j, t = _same(case_amp_replay, atol=1e-2, rtol=2.0 ** -7)
    assert t["amp_equal"] and t["cache"] == 2


# -- the port's own: computations apply_op never saw -------------------------

def test_unrecorded_computation_stays_eager():
    """A plain torch module (the port's Llama) runs its ops outside
    ``apply_op``: a recording whose result came from them must not
    replay (it would hand back the first call's tensor)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    tpaddle.seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.eval()
    sf = tsot.SOTFunction(lambda ids: m(ids))
    rng = np.random.default_rng(8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            ids = torch.as_tensor(rng.integers(0, 128, (1, 8)))
            with torch.no_grad():
                got, want = sf(ids), m(ids)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sf.stats["fallbacks"] == {"unrecorded": 1}
    assert sf.stats["records"] == 1 and sf.stats["eager_calls"] == 2
    assert any("unrecorded computation" in str(x.message) for x in w)


def test_unrecorded_guard_and_closure_stay_eager():
    """A host read of an unrecorded tensor, and an op whose function
    holds a tensor the trace computed, are unrecorded too."""
    def read(x):
        if torch.tanh(x._t).sum() > 0:        # torch call, then a read
            return x * 2
        return x * 3

    def closure(x):
        y = x * 2
        return tpaddle.core.autograd.apply_op(lambda a: a + y._t, x)

    for fn in (read, closure):
        sf = tsot.SOTFunction(fn)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for v in (1.0, -1.0, 2.0):
                x = tpaddle.to_tensor(np.full(3, v, np.float32))
                np.testing.assert_array_equal(sf(x).numpy(),
                                              fn(x).numpy())
        assert sf.stats["fallbacks"] == {"unrecorded": 1}, fn.__name__


def test_kill_switch_calls_the_plain_function():
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return x + 1

    tpaddle.set_flags({"FLAGS_sot_capture": False})
    try:
        sf = tsot.SOTFunction(f)
        for _ in range(3):
            sf(tpaddle.to_tensor(np.ones(2, np.float32)))
    finally:
        tpaddle.set_flags({"FLAGS_sot_capture": True})
    assert calls["n"] == 3 and sf.cache_size() == 0

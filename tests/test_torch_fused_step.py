"""The port's fused optimizer step, on the CPU.

On CPU tensors the fused step runs the kernels' plain versions
(``ops/kernels/multi_tensor.py``). Held here:

- against the JAX package's fused step (``fused_step.try_step`` /
  ``try_step_scaled`` with its flag on) for Adam and AdamW x each clip
  spec x precision x the plain, found and scaled modes: f32 within 1e-6
  (the JAX program is one XLA computation, which contracts some
  multiply-adds: a few ulps at parameters of size 1), bf16 within one
  bf16 rounding;
- against the port's own per-parameter loop, bit for bit;
- the gate: each fallback counted by its reason, the kill switch; f16
  and non-contiguous tensors fused, not counted; the kept table;
- lr in a device tensor, refilled only on change; TrainStep's zero
  gradients for unreached parameters; a JAX ``state_dict()`` loaded
  into the port continuing equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu_torch.amp import GradScaler as TScaler
from paddle_tpu_torch.convert import (load_from_jax,
                                      optimizer_state_dict_from_jax)
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import metrics
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.regularizer as treg
from paddle_tpu_torch.optimizer import fused_step

SHAPES = [(5, 3), (9,), (1,), (2, 3, 4)]
STEPS = 3
SCALE = 2.0 ** 10
FOUND = [False, True, False]      # the found mode's scripted flags
POISON_STEP = 1                   # the scaled mode's non-finite step
CLIPS = {"none": lambda m: None,
         "global": lambda m: m.ClipGradByGlobalNorm(1.0),
         "norm": lambda m: m.ClipGradByNorm(0.5),
         "value": lambda m: m.ClipGradByValue(0.3)}
PRECISIONS = {"f32": ("float32", True), "bf16-f32m": ("bfloat16", True),
              "bf16-bf16m": ("bfloat16", False)}
MODES = ("plain", "found", "scaled")


@pytest.fixture(autouse=True)
def _flags():
    jprev = paddle.get_flags("FLAGS_fused_optimizer")
    tprev = get_flags("FLAGS_fused_optimizer")
    paddle.set_flags({"FLAGS_fused_optimizer": 1})
    yield
    paddle.set_flags(jprev)
    set_flags(tprev)


def _counter(name):
    return metrics.default_registry().get(f"optimizer.{name}")


def _fused_steps():
    return _counter("fused_steps_total").value()


def _fallbacks(reason):
    c = _counter("fallbacks_total")
    return 0 if c is None else c.value(reason=reason)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    return ps, gs


def _grad_at(g, step, mode, scale):
    g = g * (1.0 + 0.1 * step)
    if mode == "scaled":
        g = g * scale
    return g


def _run_jax(cls, clip, precision, mode):
    dname, multi = PRECISIONS[precision]
    jd = jnp.bfloat16 if dname == "bfloat16" else jnp.float32
    ps0, gs = _data()
    ps = [paddle.Parameter(jnp.asarray(p, jd)) for p in ps0]
    sched = paddle.optimizer.lr.CosineAnnealingDecay(0.05, T_max=10)
    kw = dict(learning_rate=sched, parameters=ps, weight_decay=0.02,
              grad_clip=CLIPS[clip](paddle.nn), multi_precision=multi)
    if cls == "AdamW":
        kw["apply_decay_param_fun"] = lambda n: n != "param_1"
    opt = getattr(paddle.optimizer, cls)(**kw)
    scaler = JScaler(init_loss_scaling=SCALE, decr_every_n_nan_or_inf=1)
    for s in range(STEPS):
        scale = float(scaler._scale)
        for i, (p, g) in enumerate(zip(ps, gs)):
            a = _grad_at(g, s, mode, scale)
            if mode == "scaled" and s == POISON_STEP and i == 1:
                a[0] = np.inf
            p.grad = paddle.Tensor(jnp.asarray(a, jd))
        if mode == "plain":
            opt.step()
        elif mode == "found":
            opt._step_masked(jnp.asarray(FOUND[s]))
        else:
            scaler.step(opt)
            scaler.update()
        sched.step()
        opt.clear_grad()
    sd = {k: np.asarray(getattr(v, "_data", v), np.float32)
          for k, v in opt.state_dict().items() if k != "LR_Scheduler"}
    return [np.asarray(p._data, np.float32) for p in ps], sd, \
        float(scaler._scale)


def _run_port(cls, clip, precision, mode, fused=True, seed=0):
    set_flags({"FLAGS_fused_optimizer": fused})
    dname, multi = PRECISIONS[precision]
    td = getattr(torch, dname)
    ps0, gs = _data(seed)
    ps = [torch.from_numpy(p).to(td).requires_grad_() for p in ps0]
    sched = topt.lr.CosineAnnealingDecay(0.05, T_max=10)
    kw = dict(learning_rate=sched, parameters=ps, weight_decay=0.02,
              grad_clip=CLIPS[clip](tnn), multi_precision=multi)
    if cls == "AdamW":
        kw["apply_decay_param_fun"] = lambda n: n != "param_1"
    opt = getattr(topt, cls)(**kw)
    scaler = TScaler(init_loss_scaling=SCALE, decr_every_n_nan_or_inf=1,
                     device="cpu")
    for s in range(STEPS):
        scale = float(scaler._scale)
        for i, (p, g) in enumerate(zip(ps, gs)):
            a = _grad_at(g, s, mode, scale)
            if mode == "scaled" and s == POISON_STEP and i == 1:
                a[0] = np.inf
            p.grad = torch.from_numpy(a).to(td)
        if mode == "plain":
            opt.step()
        elif mode == "found":
            opt._step_masked(torch.tensor(FOUND[s]))
        else:
            scaler.step(opt)
            scaler.update()
        sched.step()
        opt.clear_grad()
    return ps, opt.state_dict(), float(scaler._scale)


def _close(a, b, dname):
    if dname == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=0)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


CASES = [(c, clip, prec, mode) for mode in MODES for prec in PRECISIONS
         for clip in CLIPS for c in ("Adam", "AdamW")
         # both classes under every clip in f32; bf16 alternates the class
         if prec == "f32" or (c == "Adam") == (clip in ("none", "norm"))]


@pytest.mark.parametrize("cls,clip,precision,mode", CASES,
                         ids=["-".join(c) for c in CASES])
def test_fused_step_matches_jax_fused_step(cls, clip, precision, mode):
    before = _fused_steps()
    tps, tsd, tscale = _run_port(cls, clip, precision, mode)
    assert _fused_steps() - before == STEPS
    assert tsd.pop("LR_Scheduler")["last_epoch"] == STEPS
    jps, jsd, jscale = _run_jax(cls, clip, precision, mode)
    dname = PRECISIONS[precision][0]
    for a, b in zip(tps, jps):
        _close(a.detach().float().numpy(), b, dname)
    assert set(tsd) == set(jsd)
    for k, v in jsd.items():
        got = tsd[k].float().numpy() if isinstance(tsd[k], torch.Tensor) \
            else np.float32(tsd[k])
        md = dname if "moment" in k and not PRECISIONS[precision][1] \
            else "float32"
        _close(got, v, md)
    assert tscale == jscale


LOOP_CASES = [(c, clip, prec, mode) for mode in MODES for prec in PRECISIONS
              for clip in CLIPS for c in ("Adam", "AdamW")]


@pytest.mark.parametrize("cls,clip,precision,mode", LOOP_CASES,
                         ids=["-".join(c) for c in LOOP_CASES])
def test_fused_step_is_bit_equal_to_the_loop(cls, clip, precision, mode):
    before = _fused_steps()
    fps, fsd, fscale = _run_port(cls, clip, precision, mode, fused=True,
                                 seed=3)
    assert _fused_steps() - before == STEPS
    lps, lsd, lscale = _run_port(cls, clip, precision, mode, fused=False,
                                 seed=3)
    assert _fused_steps() - before == STEPS    # the kill switch: no step
    for a, b in zip(fps, lps):
        assert torch.equal(a, b)
    assert set(fsd) == set(lsd)
    for k in fsd:
        a, b = fsd[k], lsd[k]
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert fscale == lscale


def _one_step(opt, ps):
    for p in ps:
        p.grad = torch.ones_like(p)
    before = _fused_steps()
    opt.step()
    return _fused_steps() - before


def _params(n=2, dtype=torch.float32):
    return [torch.ones(3, dtype=dtype, requires_grad=True) for _ in range(n)]


class _MyClip(tnn.ClipGradByGlobalNorm):
    pass


class _MyAdam(topt.Adam):
    pass


class _MySGD(topt.SGD):
    pass


class _MyMomentum(topt.Momentum):
    pass


@pytest.mark.parametrize("reason,make", [
    ("regularizer", lambda ps: topt.Adam(
        parameters=ps, weight_decay=treg.L1Decay(0.01))),
    ("grad_clip", lambda ps: topt.AdamW(parameters=ps,
                                        grad_clip=_MyClip(1.0))),
    # SGD and Momentum take the fused step since the vision slice: a
    # subclass of each (its update may differ) is counted
    ("optimizer_type", lambda ps: _MySGD(parameters=ps)),
    ("optimizer_type", lambda ps: _MyMomentum(parameters=ps)),
    ("optimizer_type", lambda ps: _MyAdam(parameters=ps)),
    ("duplicate_param", lambda ps: topt.Adam(parameters=[ps[0], ps[0]])),
], ids=["L1Decay", "clip-subclass", "SGD", "Momentum", "Adam-subclass",
        "duplicate"])
def test_fallbacks_are_counted_by_reason(reason, make):
    ps = _params()
    opt = make(ps)
    before = _fallbacks(reason)
    flight.clear()
    assert _one_step(opt, ps) == 0
    assert _fallbacks(reason) == before + 1
    assert any(e["name"] == "fallback" and e["attrs"]["reason"] == reason
               for e in flight.events(category="optimizer"))
    assert not torch.equal(ps[0], torch.ones(3))   # the loop ran


def _layout_case(kind):
    """Parameters and gradients of one layout / dtype case."""
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    if kind == "f16":
        return [t(5, 3).half().requires_grad_(), t(7).half()
                .requires_grad_()], lambda p, s: (t(*p.shape) * (s + 1)
                                                  ).to(p.dtype)
    # a transposed parameter (its moments transposed too), a parameter
    # whose gradient is a strided slice, a plain one
    ps = [t(3, 4).t().requires_grad_(), t(6).requires_grad_(),
          t(2).requires_grad_()]
    return ps, lambda p, s: (t(2 * p.numel())[::2].view(p.shape) * (s + 1)
                             if p.dim() == 1 and p.numel() == 6
                             else t(*p.shape).t().contiguous().t()
                             if p.dim() == 2 else t(*p.shape))


def test_layout_dtype_and_closure_fallbacks():
    """f16 parameters and non-contiguous parameters, moments and
    gradients are not fallbacks: they take the fused step, no reason
    counted, bit-equal to the loop; a closure step (LBFGS) is one."""
    total = _counter("fallbacks_total").total()
    for kind, cls, multi in (("f16", topt.Adam, True),
                             ("f16", topt.AdamW, False),
                             ("strided", topt.AdamW, True)):
        runs = []
        for fused in (True, False):
            set_flags({"FLAGS_fused_optimizer": fused})
            ps, grad = _layout_case(kind)
            opt = cls(learning_rate=0.05, parameters=ps, weight_decay=0.02,
                      multi_precision=multi,
                      grad_clip=tnn.ClipGradByGlobalNorm(1.0))
            before = _fused_steps()
            for s in range(2):
                for p in ps:
                    p.grad = grad(p, s)
                opt.step()
            assert _fused_steps() - before == (2 if fused else 0)
            runs.append((ps, opt.state_dict()))
        (fps, fsd), (lps, lsd) = runs
        for a, b in zip(fps, lps):
            assert a.dtype == b.dtype and a.stride() == b.stride()
            assert torch.equal(a, b)
        for k in fsd:
            assert torch.equal(fsd[k], lsd[k]) \
                if isinstance(fsd[k], torch.Tensor) else fsd[k] == lsd[k]
    assert not fps[0].is_contiguous()
    assert _counter("fallbacks_total").total() == total
    set_flags({"FLAGS_fused_optimizer": True})
    lb = topt.LBFGS(parameters=_params(1))
    before = _fallbacks("optimizer")
    assert not fused_step.try_step(lb, [(p, torch.ones(3))
                                        for p in lb._parameter_list])
    assert _fallbacks("optimizer") == before + 1


def test_the_optimizer_keeps_its_table_until_a_tensor_moves():
    """Steps over the same parameters and states reuse one AdamTable;
    states replaced (set_state_dict, a step through the loop), a
    parameter's data replaced or a decay changed build it anew, and the
    steps stay bit-equal to the loop's."""
    runs = []
    for fused in (True, False):
        ps, grad = _layout_case("strided")
        opt = topt.AdamW(learning_rate=0.05, parameters=ps,
                         weight_decay=0.02)
        tables = []

        def step(s, flag=fused):
            set_flags({"FLAGS_fused_optimizer": flag})
            for p in ps:
                p.grad = grad(p, s)
            opt.step()
            tables.append(getattr(opt, "_fused_table", (None, None))[1])

        step(0)
        step(1)
        opt.set_state_dict(opt.state_dict())
        step(2)
        step(3, False)          # the loop replaces the states
        step(4)
        with torch.no_grad():
            ps[2].data = ps[2].data.clone()
        step(5)
        opt._weight_decay = 0.03
        step(6)
        step(7)
        runs.append((ps, opt.state_dict(), tables))
    (fps, fsd, ft), (lps, lsd, _) = runs
    assert ft[0] is not None and ft[1] is ft[0]
    assert len({id(t) for t in ft[:3]}) == 2      # set_state_dict
    assert ft[4] is not ft[2] and ft[5] is not ft[4]   # loop, p.data
    assert ft[6] is not ft[5] and ft[7] is ft[6]       # decay
    for a, b in zip(fps, lps):
        assert torch.equal(a, b)
    for k in fsd:
        assert torch.equal(fsd[k], lsd[k]) \
            if isinstance(fsd[k], torch.Tensor) else fsd[k] == lsd[k]


def test_frozen_parameter_grads_fall_back_on_the_scaled_path():
    ps = _params(2)
    frozen = torch.ones(3)
    frozen.grad = torch.ones(3)
    opt = topt.Adam(parameters=ps + [frozen])
    for p in ps:
        p.grad = torch.ones(3)
    before = _fallbacks("frozen_param_grads")
    assert fused_step.try_step_scaled(opt, torch.tensor(2.0)) is None
    assert _fallbacks("frozen_param_grads") == before + 1


def test_kill_switch_runs_the_loop_uncounted():
    ps = _params()
    opt = topt.AdamW(parameters=ps)
    set_flags({"FLAGS_fused_optimizer": False})
    assert not fused_step.enabled()
    before = _counter("fallbacks_total").total()
    assert _one_step(opt, ps) == 0
    assert _counter("fallbacks_total").total() == before
    assert not torch.equal(ps[0], torch.ones(3))
    set_flags({"FLAGS_fused_optimizer": True})
    assert fused_step.enabled() and _one_step(opt, ps) == 1


def test_lr_lives_in_a_device_tensor_refilled_on_change(monkeypatch):
    ps = _params()
    sched = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = topt.AdamW(learning_rate=sched, parameters=ps)
    fills = []
    real_fill = torch.Tensor.fill_

    def fill(t, v):
        fills.append(v)
        return real_fill(t, v)

    monkeypatch.setattr(torch.Tensor, "fill_", fill)
    seen = set()
    for _ in range(5):
        _one_step(opt, ps)
        seen.add(id(opt._fused_lr_dev))
        assert opt._fused_lr_dev.dtype == torch.float32
        assert float(opt._fused_lr_dev) == np.float32(sched())
        sched.step()
    assert len(seen) == 1
    assert fills == [0.1, 0.05, 0.025]


def test_unscale_and_check_and_apply_update_tail():
    gs = [torch.tensor([2.0, 4.0]), torch.tensor([8.0], dtype=torch.bfloat16)]
    out, found = fused_step.unscale_and_check(gs, torch.tensor(0.5))
    assert out[0].tolist() == [1.0, 2.0] and out[1].item() == 4.0
    assert found.dtype == torch.bool and not found
    gs[0][0] = float("nan")
    assert fused_step.unscale_and_check(gs, torch.tensor(1.0))[1]
    ps = _params(1)
    opt = topt.SGD(learning_rate=0.5, parameters=ps)
    new_ps, new_ss = fused_step.apply_update_tail(
        opt, ps, [torch.full((3,), 4.0)], 0.5, ("global_norm", 1.0))
    np.testing.assert_allclose(new_ps[0].detach().numpy(),
                               1 - 0.5 / np.sqrt(3), rtol=1e-6)
    assert torch.equal(ps[0], torch.ones(3)) and new_ss == [{}]


def test_train_step_zero_grads_enter_the_fused_table():
    """A parameter the loss does not reach gets TrainStep's zero
    gradient, goes through the kernels with the others, and is decayed
    exactly as the loop decays it."""

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = torch.nn.Linear(4, 2)
            self.unused = torch.nn.Parameter(torch.ones(3))

        def forward(self, x):
            return self.used(x)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 4)).astype(np.float32))
    results = []
    for fused in (True, False):
        set_flags({"FLAGS_fused_optimizer": fused})
        torch.manual_seed(0)
        model = Two()
        opt = topt.AdamW(learning_rate=0.1, weight_decay=0.5,
                         parameters=model.named_parameters())
        step = TrainStep(model, lambda out: out.square().mean(), opt)
        before = _fused_steps()
        step(x)
        assert _fused_steps() - before == int(fused)
        results.append({n: p.detach().clone()
                        for n, p in model.named_parameters()})
    for n, a in results[0].items():
        assert torch.equal(a, results[1][n])
    # a zero gradient: AdamW's step is its decay alone, lr * wd * p
    np.testing.assert_allclose(results[0]["unused"].numpy(),
                               1 - 0.1 * 0.5, rtol=1e-6)


def test_jax_state_dict_loads_and_both_continue_equal():
    """AdamW with a scheduler on a Linear layer (the port stores its
    weight transposed): two JAX steps, its weights and state_dict() as
    numpy into the port, three more steps on both sides with the same
    gradients (the JAX side through its per-parameter loop)."""
    paddle.set_flags({"FLAGS_fused_optimizer": 0})
    paddle.seed(3)
    jm = paddle.nn.Linear(4, 3)
    tm = torch.nn.Linear(4, 3)
    names = [n for n, _ in jm.named_parameters()]
    rng = np.random.default_rng(5)
    grads = [{n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
              for n, p in jm.named_parameters()} for _ in range(5)]
    jsched = paddle.optimizer.lr.CosineAnnealingDecay(0.05, T_max=8)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched, weight_decay=0.1,
                                  parameters=jm.parameters())

    def jstep(g):
        for n, p in jm.named_parameters():
            p.grad = paddle.to_tensor(g[n])
        jopt.step()
        jsched.step()
        jopt.clear_grad()

    for g in grads[:2]:
        jstep(g)
    # the checkpoint: the JAX weights and optimizer state, as numpy
    load_from_jax(tm, {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()})
    jsd = {k: (v if k in ("global_step", "LR_Scheduler")
               else np.asarray(v._data)) for k, v in
           jopt.state_dict().items()}
    tsched = topt.lr.CosineAnnealingDecay(0.05, T_max=8)
    topt_ = topt.AdamW(learning_rate=tsched, weight_decay=0.1,
                       parameters=tm.named_parameters())
    topt_.set_state_dict(optimizer_state_dict_from_jax(
        jsd, names=names, port_names=topt_._param_names, model=tm))
    assert tsched.last_epoch == jsched.last_epoch == 2
    assert topt_._global_step == 2
    for g in grads[2:]:
        jstep(g)
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[n].T.copy() if n == "weight"
                                      else g[n])
        topt_.step()
        tsched.step()
        topt_.clear_grad()
    tsd = topt_.state_dict()
    assert set(tsd) == set(jopt.state_dict())
    for n, p in jm.named_parameters():
        want = np.asarray(p._data)
        got = dict(tm.named_parameters())[n].detach().numpy()
        np.testing.assert_allclose(got.T if n == "weight" else got, want,
                                   rtol=1e-6, atol=1e-7)

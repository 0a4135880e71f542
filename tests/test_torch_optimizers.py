"""Every optimizer of the port against the JAX package's, on the CPU.

The same f32 parameters and gradients (numpy, seeded) go through each
JAX optimizer and its port for 5 steps (a cosine LR schedule where the
optimizer takes one). The JAX side runs its per-parameter update loop
(``FLAGS_fused_optimizer=0``: each operation rounded on its own, as the
port's); the port's Adam and AdamW take the fused step (the kernels'
plain versions on the CPU), every other optimizer its per-parameter
loop. Parameters and every state slot (compared through ``state_dict()``,
whose keys must be equal) agree within 1e-6 relative (they come out
bit-equal but for Lamb's norms, summed in another order).
``tests/test_torch_fused_step.py`` holds the port against the JAX fused
program. LBFGS runs with a closure on a least-squares problem.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.regularizer as jreg
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.regularizer as treg

SHAPES = [(4, 3), (7,), (1,)]
STEPS = 5
JAX = dict(opt=paddle.optimizer, reg=jreg)
PORT = dict(opt=topt, reg=treg)


@pytest.fixture(autouse=True)
def _jax_loop():
    prev = paddle.get_flags("FLAGS_fused_optimizer")
    paddle.set_flags({"FLAGS_fused_optimizer": 0})
    yield
    paddle.set_flags(prev)


def _exclude(p):
    return tuple(p.shape) == (7,)


# (id, class name, kwargs maker (package dict) -> kwargs, scheduled)
OPTIMIZERS = [
    ("SGD", "SGD", lambda m: {}, True),
    ("SGD-wd", "SGD", lambda m: {"weight_decay": 0.01}, True),
    ("SGD-L2Decay", "SGD", lambda m: {"weight_decay": m["reg"].L2Decay(0.02)},
     True),
    ("Momentum", "Momentum", lambda m: {}, True),
    ("Momentum-nesterov", "Momentum", lambda m: {"use_nesterov": True},
     True),
    ("Momentum-L1Decay", "Momentum",
     lambda m: {"weight_decay": m["reg"].L1Decay(0.01)}, True),
    ("Adagrad", "Adagrad", lambda m: {}, True),
    ("Adam", "Adam", lambda m: {}, True),
    ("Adam-wd", "Adam", lambda m: {"weight_decay": 0.01}, True),
    ("AdamW", "AdamW", lambda m: {}, True),
    ("AdamW-decay-fun", "AdamW",
     lambda m: {"apply_decay_param_fun": lambda n: n != "param_1"}, True),
    ("Adamax", "Adamax", lambda m: {}, True),
    ("RMSProp", "RMSProp", lambda m: {}, True),
    ("RMSProp-centered", "RMSProp",
     lambda m: {"centered": True, "momentum": 0.9}, True),
    ("Lamb", "Lamb", lambda m: {}, True),
    ("Lamb-exclude", "Lamb",
     lambda m: {"exclude_from_weight_decay_fn": _exclude}, True),
    ("Adadelta", "Adadelta", lambda m: {}, True),
    ("ASGD", "ASGD", lambda m: {"batch_num": 2, "weight_decay": 0.01},
     True),
    ("NAdam", "NAdam", lambda m: {}, True),
    ("RAdam", "RAdam", lambda m: {}, True),
    ("Rprop", "Rprop", lambda m: {}, False),
]
LR = {"Adagrad": 0.05, "RMSProp": 0.01, "Rprop": 0.01}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    return ps, gs


def _run_jax(cls, kw, scheduled, ps0, gs):
    ps = [paddle.Parameter(p.copy()) for p in ps0]
    lr = LR.get(cls, 0.05)
    sched = paddle.optimizer.lr.CosineAnnealingDecay(lr, T_max=10) \
        if scheduled else None
    opt = getattr(paddle.optimizer, cls)(
        learning_rate=sched or lr, parameters=ps, **kw)
    for s in range(STEPS):
        for p, g in zip(ps, gs):
            p.grad = paddle.to_tensor(g * (1.0 + 0.1 * s))
        opt.step()
        if sched is not None:
            sched.step()
        opt.clear_grad()
    return [np.asarray(p._data) for p in ps], {
        k: np.asarray(getattr(v, "_data", v))
        for k, v in opt.state_dict().items() if k != "LR_Scheduler"}


def _run_port(cls, kw, scheduled, ps0, gs):
    ps = [torch.from_numpy(p.copy()).requires_grad_() for p in ps0]
    lr = LR.get(cls, 0.05)
    sched = topt.lr.CosineAnnealingDecay(lr, T_max=10) if scheduled \
        else None
    opt = getattr(topt, cls)(learning_rate=sched or lr, parameters=ps, **kw)
    for s in range(STEPS):
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g * (1.0 + 0.1 * s))
        opt.step()
        if sched is not None:
            sched.step()
        opt.clear_grad()
    return [p.detach().numpy() for p in ps], {
        k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in opt.state_dict().items() if k != "LR_Scheduler"}


def test_every_optimizer_is_covered():
    names = {"SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
             "RMSProp", "Lamb", "Adadelta", "ASGD", "NAdam", "RAdam",
             "Rprop", "LBFGS"}
    for n in names:
        assert issubclass(getattr(topt, n), topt.Optimizer)
    assert names - {"LBFGS"} == {c for _, c, _, _ in OPTIMIZERS}


@pytest.mark.parametrize("cls,build,scheduled",
                         [(c, b, s) for _, c, b, s in OPTIMIZERS],
                         ids=[i for i, _, _, _ in OPTIMIZERS])
def test_optimizer_matches_jax(cls, build, scheduled):
    ps0, gs = _data()
    jp, jsd = _run_jax(cls, build(JAX), scheduled, ps0, gs)
    tp, tsd = _run_port(cls, build(PORT), scheduled, ps0, gs)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_allclose(np.asarray(tsd[k], np.float64),
                                   np.asarray(jsd[k], np.float64),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(tsd["global_step"]) == STEPS


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"],
                         ids=["plain", "strong-wolfe"])
def test_lbfgs_with_a_closure_matches_jax(line_search):
    """Two LBFGS steps on 0.5 ||A x - b||^2 from the same x."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x0 = rng.standard_normal(4).astype(np.float32)

    jx = paddle.Parameter(x0.copy())
    jopt = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=4,
                                  line_search_fn=line_search,
                                  parameters=[jx])
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)

    def jclosure():
        jopt.clear_grad()
        r = paddle.matmul(ja, jx) - jb
        loss = (r * r).sum() * 0.5
        loss.backward()
        return loss

    tx = torch.from_numpy(x0.copy()).requires_grad_()
    tlb = topt.LBFGS(learning_rate=1.0, max_iter=4,
                     line_search_fn=line_search, parameters=[tx])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def tclosure():
        tlb.clear_grad()
        r = ta @ tx - tb
        loss = (r * r).sum() * 0.5
        loss.backward()
        return loss

    losses = []
    for _ in range(2):
        jl = float(jopt.step(jclosure))
        tl = float(tlb.step(tclosure).detach())
        losses.append(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx._data),
                                   rtol=1e-4, atol=1e-5)
    assert losses[1] < losses[0]
    with pytest.raises(ValueError, match="closure"):
        tlb.step()


def test_optimizer_surface():
    """get_lr / set_lr, clear_grad(set_to_zero), minimize and the
    weight_decay forms."""
    p = torch.ones(3, requires_grad=True)
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    sched = topt.lr.StepDecay(0.1, step_size=1)
    sopt = topt.SGD(learning_rate=sched, parameters=[p])
    with pytest.raises(RuntimeError, match="scheduler"):
        sopt.set_lr(0.3)
    opt.minimize((p * p).sum())
    np.testing.assert_allclose(p.detach().numpy(), 0.5)
    assert p.grad is None
    (p * 2).sum().backward()
    opt.clear_grad(set_to_zero=True)
    assert p.grad is not None and not p.grad.any()
    assert topt.SGD(parameters=[p], weight_decay=treg.L2Decay(0.3)) \
        ._weight_decay == 0.3
    l1 = topt.SGD(parameters=[p], weight_decay=treg.L1Decay(0.3))
    assert l1._weight_decay == 0.0 and l1._regularizer.coeff == 0.3
    with pytest.raises(ValueError, match="parameters"):
        topt.SGD()

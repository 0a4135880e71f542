"""The port's GradScaler against the JAX package's, on the CPU.

A scripted run of finite and non-finite steps drives both scalers
around an AdamW optimizer with the same gradients (the loss scale
applied to them, an inf planted on the non-finite steps): the scale and
the good/bad counters after every ``update()`` must be equal, and the
parameters after the run within 1e-6 (the JAX side runs its fused
program). The port runs its fused step (the kernels' plain versions on
the CPU) and, with ``FLAGS_fused_optimizer=0``, its unscale + masked
loop: both give the same sequence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu_torch.amp import GradScaler as TScaler
from paddle_tpu_torch.convert import grad_scaler_state_from_jax
from paddle_tpu_torch.core.flags import set_flags
import paddle_tpu_torch.optimizer as topt

SHAPES = [(4, 3), (5,)]
SCRIPTS = {
    # good steps double the scale every 2, bad ones halve it every 2
    "mixed": dict(init=16.0, incr=2, decr=2,
                  bad=[0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0]),
    # a run of bad steps drives the scale down to its floor of 1
    "floor": dict(init=4.0, incr=3, decr=1, bad=[1, 1, 1, 1, 0, 0, 0, 1]),
}


@pytest.fixture(autouse=True)
def _flags():
    jprev = paddle.get_flags("FLAGS_fused_optimizer")
    paddle.set_flags({"FLAGS_fused_optimizer": 1})
    yield
    paddle.set_flags(jprev)
    set_flags({"FLAGS_fused_optimizer": True})


def _grads(step):
    rng = np.random.default_rng(step)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _params():
    rng = np.random.default_rng(99)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _run_jax(script, unscale_first=False):
    ps = [paddle.Parameter(p) for p in _params()]
    opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=ps)
    sc = JScaler(init_loss_scaling=script["init"],
                 incr_every_n_steps=script["incr"],
                 decr_every_n_nan_or_inf=script["decr"])
    seq = []
    for s, bad in enumerate(script["bad"]):
        scale = float(sc._scale)
        for i, (p, g) in enumerate(zip(ps, _grads(s))):
            g = g * scale
            if bad and i == 0:
                g[1, 2] = np.inf
            p.grad = paddle.Tensor(jnp.asarray(g))
        if unscale_first:
            sc.unscale_(opt)
        sc.step(opt)
        sc.update()
        opt.clear_grad()
        seq.append((float(sc._scale), int(sc._good_steps),
                    int(sc._bad_steps)))
    return seq, [np.asarray(p._data) for p in ps], sc


def _run_port(script, fused=True, unscale_first=False):
    set_flags({"FLAGS_fused_optimizer": fused})
    ps = [torch.from_numpy(p).requires_grad_() for p in _params()]
    opt = topt.AdamW(learning_rate=0.01, parameters=ps)
    sc = TScaler(init_loss_scaling=script["init"],
                 incr_every_n_steps=script["incr"],
                 decr_every_n_nan_or_inf=script["decr"], device="cpu")
    seq = []
    for s, bad in enumerate(script["bad"]):
        scale = float(sc._scale)
        for i, (p, g) in enumerate(zip(ps, _grads(s))):
            g = g * scale
            if bad and i == 0:
                g[1, 2] = np.inf
            p.grad = torch.from_numpy(g)
        if unscale_first:
            sc.unscale_(opt)
        sc.step(opt)
        sc.update()
        opt.clear_grad()
        seq.append((float(sc._scale), int(sc._good_steps),
                    int(sc._bad_steps)))
    return seq, [p.detach().numpy() for p in ps], sc


@pytest.mark.parametrize("unscale_first", [False, True],
                         ids=["step", "unscale-then-step"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scale_and_counters_follow_jax(name, fused, unscale_first):
    script = SCRIPTS[name]
    jseq, jps, jsc = _run_jax(script, unscale_first)
    tseq, tps, tsc = _run_port(script, fused, unscale_first)
    assert tseq == jseq
    for a, b in zip(tps, jps):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert tsc.state_dict() == jsc.state_dict()


def test_state_dict_carries_across():
    jseq, _, jsc = _run_jax(SCRIPTS["mixed"])
    sc = TScaler(device="cpu")
    sc.load_state_dict(grad_scaler_state_from_jax(jsc.state_dict()))
    assert sc.state_dict() == jsc.state_dict()
    assert (float(sc.get_loss_scaling()), int(sc._good_steps),
            int(sc._bad_steps)) == jseq[-1]
    sc.set_init_loss_scaling(8.0)
    assert float(sc._scale) == 8.0 and sc._scale.dtype == torch.float32


def test_scale_keeps_the_loss_dtype_and_minimize():
    sc = TScaler(init_loss_scaling=4.0, device="cpu")
    loss = torch.tensor(1.5, dtype=torch.bfloat16)
    assert sc.scale(loss).dtype == torch.bfloat16
    assert float(sc.scale(loss)) == 6.0
    p = torch.ones(2, requires_grad=True)
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    sc.minimize(opt, sc.scale((p * p).sum()))
    np.testing.assert_allclose(p.detach().numpy(), 0.0)
    off = TScaler(enable=False, device="cpu")
    assert off.scale(loss) is loss and not off.is_enable()
    assert sc.is_use_dynamic_loss_scaling()


class _CustomStep(topt.SGD):
    """An optimizer with its own step(): the scaler's host path."""
    calls = 0

    def step(self):
        type(self).calls += 1
        super().step()


def test_custom_step_takes_the_host_decision_path():
    p = torch.ones(2, requires_grad=True)
    opt = _CustomStep(learning_rate=0.5, parameters=[p])
    sc = TScaler(init_loss_scaling=2.0, decr_every_n_nan_or_inf=1,
                 device="cpu")
    p.grad = torch.tensor([2.0, float("inf")])
    sc.step(opt)
    sc.update()
    assert _CustomStep.calls == 0 and float(sc._scale) == 1.0
    p.grad = torch.tensor([2.0, 4.0])
    sc.step(opt)
    assert _CustomStep.calls == 1
    np.testing.assert_allclose(p.detach().numpy(), [0.0, -1.0])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TScaler()

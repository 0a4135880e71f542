"""The port's training slice against the JAX package's, on the CPU.

The same inputs (numpy, seeded) and the same weights (copied with
``convert``) go through the JAX function and the port's: the fused
cross-entropy, one AdamW update, and three ``TrainStep``s of a tiny
Llama with flash attention (the JAX side runs its XLA path on the CPU,
the port its plain flash walk). Tolerances are f32 ones: the two
frameworks sum in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.ops.fused_ce import fused_softmax_ce_mean as jax_ce
from paddle_tpu_torch.convert import (LINEAR_WEIGHTS, load_from_jax,
                                      optimizer_state_from_jax)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.ops.fused_ce import fused_softmax_ce_mean
from paddle_tpu_torch.optimizer import Adam, AdamW

LR, STEPS = 1e-3, 3


def _linear(name):
    return name.split(".")[-2] in LINEAR_WEIGHTS


def _port_layout(name, a):
    a = np.asarray(a)
    return a.T if _linear(name) and a.ndim == 2 else a


# -- fused cross-entropy -----------------------------------------------------

@pytest.mark.parametrize("seq,ignore", [(300, None), (300, -100),
                                        (37, -100)],
                         ids=["L300", "L300-ignore", "L37-ignore"])
def test_fused_ce_loss_and_grad_match_jax(seq, ignore):
    rng = np.random.default_rng(seq)
    logits = (3 * rng.standard_normal((2, seq, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, seq)).astype(np.int32)
    if ignore is not None:
        labels[0, :7] = ignore
        labels[1, -1] = ignore
    want, vjp = __import__("jax").vjp(
        lambda lg: jax_ce(lg, jnp.asarray(labels), ignore), logits)
    (want_grad,) = vjp(jnp.float32(1.5))
    lg = torch.from_numpy(logits).requires_grad_()
    loss = fused_softmax_ce_mean(lg, torch.from_numpy(labels).long(),
                                 ignore_index=ignore)
    (loss * 1.5).backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad),
                               atol=1e-7, rtol=1e-5)
    if ignore is not None:
        assert not lg.grad[0, :7].any()


def test_fused_ce_keeps_the_logits_dtype():
    rng = np.random.default_rng(1)
    lg = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(
        np.float32)).bfloat16().requires_grad_()
    lb = torch.from_numpy(rng.integers(0, 16, (1, 8)))
    loss = fused_softmax_ce_mean(lg, lb)
    loss.backward()
    assert loss.dtype == torch.float32 and lg.grad.dtype == torch.bfloat16


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,multi", [("float32", True),
                                         ("bfloat16", False)],
                         ids=["f32", "bf16-moments"])
@pytest.mark.parametrize("cls", ["AdamW", "Adam"])
def test_adamw_update_matches_jax(cls, dtype, multi):
    """One ``_update`` per parameter on fixed p, g and a mid-run state;
    for AdamW ``apply_decay_param_fun`` exempts the second parameter
    (JAX names unnamed parameters ``param_{i}``, as the port does); Adam
    folds its decay into the gradient."""
    rng = np.random.default_rng(3)
    shapes = [(6, 5), (5,)]
    jparams = [paddle.create_parameter(list(s), "float32") for s in shapes]
    tparams = [torch.zeros(s) for s in shapes]
    kw = dict(learning_rate=LR, weight_decay=0.1, multi_precision=multi)
    if cls == "AdamW":
        kw["apply_decay_param_fun"] = lambda n: n != "param_1"
    jopt = getattr(paddle.optimizer, cls)(parameters=jparams, **kw)
    topt = {"AdamW": AdamW, "Adam": Adam}[cls](parameters=tparams, **kw)
    tdt = getattr(torch, dtype)
    for i, (jp, s) in enumerate(zip(jparams, shapes)):
        p, g, m1 = (rng.standard_normal(s).astype(np.float32)
                    for _ in range(3))
        m2 = rng.random(s).astype(np.float32)
        state = dict(moment1=m1, moment2=m2, beta1_pow=np.float32(0.9 ** 3),
                     beta2_pow=np.float32(0.999 ** 3))
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        md = jdt if not multi else jnp.float32
        jopt._current_pid = id(jp)
        want_p, want_s = jopt._update(
            jnp.asarray(p, jdt), jnp.asarray(g, jdt),
            {k: jnp.asarray(v, md if k.startswith("moment") else
                            jnp.float32) for k, v in state.items()}, LR)
        mt = tdt if not multi else torch.float32
        got_p, got_s = topt._update(
            torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
            {k: torch.as_tensor(v).to(mt if k.startswith("moment") else
                                      torch.float32)
             for k, v in state.items()}, LR, i)
        assert got_p.dtype == tdt
        assert got_s["moment1"].dtype == mt
        tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
            dict(atol=0, rtol=2 ** -8)   # one bf16 rounding apart at most
        np.testing.assert_allclose(got_p.float().numpy(),
                                   np.asarray(want_p, np.float32), **tol)
        for k in want_s:
            np.testing.assert_allclose(
                got_s[k].float().numpy(), np.asarray(want_s[k], np.float32),
                **tol)
        assert topt._use_wd(i) == (0.0 if i == 1 and cls == "AdamW"
                                   else 0.1)


# -- the slice as a whole ----------------------------------------------------

def _jax_grads(jm, jcrit, ids):
    loss = jcrit(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    loss.backward()
    grads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    return float(loss), grads


@pytest.fixture(scope="module")
def trained():
    """Tiny Llama (GQA 4/2, flash attention) on both sides from the same
    weights; the first step's gradients, then three TrainSteps each."""
    paddle.seed(11)
    cfg = dict(use_flash_attention=True)
    jm = JaxLlama(JaxConfig.tiny(**cfg))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_from_jax(tm, arrays)
    ids = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(
        np.int32)
    jcrit, tcrit = JaxCriterion(), LlamaPretrainingCriterion()

    jloss0, jgrads = _jax_grads(jm, jcrit, ids)
    tids = torch.from_numpy(ids).long()
    tloss0 = tcrit(tm(tids), tids)
    tloss0.backward()
    tgrads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)

    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt)
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters())
    tstep = TrainStep(tm, tcrit, topt)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))))
        tl.append(tstep(tids, tids))
    return dict(jm=jm, tm=tm, jopt=jopt, topt=topt, ids=ids, jcrit=jcrit,
                jstep=jstep, jgrads=jgrads, tgrads=tgrads, jloss0=jloss0,
                tloss0=tloss0.item(), jl=jl, tl=tl)


def test_train_steps_track_jax_losses(trained):
    t = trained
    assert all(x.dtype == torch.float32 and x.dim() == 0 for x in t["tl"])
    np.testing.assert_allclose(t["tloss0"], t["jloss0"], rtol=1e-5)
    np.testing.assert_allclose([x.item() for x in t["tl"]], t["jl"],
                               rtol=1e-5)
    assert t["jl"][-1] < t["jl"][0]


def test_first_step_gradients_match_jax(trained):
    t = trained
    assert set(t["tgrads"]) == set(t["jgrads"])
    for name, g in t["tgrads"].items():
        ref = _port_layout(name, t["jgrads"][name])
        err = np.abs(g.numpy() - ref)
        assert (err <= 1e-5 + 1e-4 * np.abs(ref)).all(), \
            (name, float(err.max()))


def test_parameters_after_three_steps_match_jax(trained):
    """AdamW turns a sign flip of a near-zero gradient into a whole lr
    step, so: 99 % of the elements within 1e-5, all within
    3 * lr * steps."""
    t = trained
    tparams = dict(t["tm"].named_parameters())
    n_close = n_all = 0
    for name, p in t["jm"].named_parameters():
        ref = _port_layout(name, p._data)
        err = np.abs(tparams[name].detach().numpy() - ref)
        assert err.max() <= 3 * LR * STEPS, (name, float(err.max()))
        n_close += int((err <= 1e-5).sum())
        n_all += err.size
    assert n_close >= 0.99 * n_all, n_close / n_all


def _jax_named_states(jm, jopt):
    out = {}
    for name, p in jm.named_parameters():
        s = jopt._states[id(p)]
        out[name] = {k: np.asarray(getattr(v, "_data", v))
                     for k, v in s.items()}
    return out


def test_optimizer_state_from_jax_round_trips_and_resumes(trained):
    t = trained
    jstates = _jax_named_states(t["jm"], t["jopt"])
    conv = optimizer_state_from_jax(jstates)
    # a fresh port model and optimizer from the JAX weights and state
    tm2 = LlamaForCausalLM(LlamaConfig.tiny(use_flash_attention=True),
                           device="cpu")
    load_from_jax(tm2, {n: np.asarray(p._data)
                        for n, p in t["jm"].named_parameters()})
    opt2 = AdamW(learning_rate=LR, parameters=tm2.named_parameters())
    opt2.set_named_states(conv)
    back = opt2.named_states()
    assert set(back) == set(jstates)
    for name, slots in jstates.items():
        assert set(back[name]) == set(slots)
        for k, a in slots.items():
            np.testing.assert_array_equal(
                _port_layout(name, back[name][k].numpy()), a)
    # one more step on each side from the same point
    ids = t["ids"]
    jl = float(t["jstep"](paddle.to_tensor(ids), paddle.to_tensor(ids)))
    tids = torch.from_numpy(ids).long()
    tl = TrainStep(tm2, LlamaPretrainingCriterion(), opt2)(tids, tids)
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    tparams = dict(tm2.named_parameters())
    for name, p in t["jm"].named_parameters():
        err = np.abs(tparams[name].detach().numpy()
                     - _port_layout(name, p._data))
        assert err.max() <= 2 * LR, (name, float(err.max()))
    with pytest.raises(KeyError):
        opt2.set_named_states({})


def test_convert_carries_bf16_arrays_exactly():
    """bf16 JAX arrays (a ``multi_precision=False`` run's moments) come
    across as torch.bfloat16, transposed for Linear weights."""
    a = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal(
        (3, 5)), jnp.bfloat16))
    conv = optimizer_state_from_jax(
        {"lm_head.weight": {"moment1": a, "beta1_pow": np.float32(0.9)}})
    m1 = conv["lm_head.weight"]["moment1"]
    assert m1.dtype == torch.bfloat16 and m1.shape == (5, 3)
    np.testing.assert_array_equal(m1.float().numpy(),
                                  a.astype(np.float32).T)
    assert conv["lm_head.weight"]["beta1_pow"].dim() == 0

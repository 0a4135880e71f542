"""The port's GPT on the paddle-API core against the JAX package's, on
the CPU.

A tiny ``GPTForCausalLM`` (2 layers, hidden 64, 4 heads of 16, vocab
128) is built by the JAX package; ``convert.gpt_from_jax`` builds the
port's from the same config and copies the weights by name without
transposes (paddle ``Linear`` keeps ``[in, out]`` on both sides). The
same ids go through both, as ``bench.py``'s GPT workload steps them:
``CrossEntropyLoss`` over ``logits.reshape([-1, vocab])``, then one
``AdamW`` step. Logits within 1e-5 + 1e-5·|ref|, the loss within rtol
1e-5, every gradient within atol 1e-5 + rtol 1e-4 (the limits of
``tests/test_torch_bert.py``), the parameters after the step within
the same. The JAX side runs jitted through ``jit.api.functionalize``
(its eager tape would compile every op) with its attention as
``tests/test_models.py`` runs GPT on the CPU; the port's goes through
the flash-attention entry (its plain versions on the CPU) or, with
``use_flash_attention=False``, the plain sdpa.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.convert import gpt_config_from_jax, gpt_from_jax
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from test_torch_moe import _jax_value_and_grads
from test_torch_tensor import port_on_cpu  # noqa: F401

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
VOCAB = 128


def _ids():
    return np.random.default_rng(0).integers(0, VOCAB, (2, 16)).astype(
        np.int64)


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _jax_step(jm, ids):
    crit = jpaddle.nn.CrossEntropyLoss()

    def fn(ids_t):
        logits = jm(ids_t)
        loss = crit(logits.reshape([-1, VOCAB]), ids_t.reshape([-1]))
        return loss, logits
    loss, logits, grads, _ = _jax_value_and_grads(jm, fn, ids)
    return loss, logits, grads


@pytest.fixture(scope="module", params=[True, False],
                ids=["flash", "plain"])
def pair(request):
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    tdevice.set_device("cpu")
    jpaddle.seed(11)
    cfg = JaxGPTConfig.tiny(use_flash_attention=request.param)
    jm = JaxGPT(cfg)
    arrays = _arrays(jm)
    tm = gpt_from_jax(cfg, arrays)
    ids = _ids()
    jloss, jlogits, jgrads = _jax_step(jm, ids)
    crit = tpaddle.nn.CrossEntropyLoss()
    tids = tpaddle.to_tensor(ids)
    tlogits = tm(tids)
    tloss = crit(tlogits.reshape([-1, VOCAB]), tids.reshape([-1]))
    tloss.backward()
    yield dict(jm=jm, tm=tm, arrays=arrays, jloss=jloss, jlogits=jlogits,
               jgrads=jgrads, tloss=tloss, tlogits=tlogits, ids=ids)
    tdevice._current = prev


def test_config_and_weights_carry_without_transposes(pair):
    tm, arrays = pair["tm"], pair["arrays"]
    assert isinstance(tm, GPTForCausalLM)
    assert gpt_config_from_jax(pair["jm"].config) == tm.config
    sd = tm.state_dict()
    assert list(sd) == list(arrays)
    for name, a in arrays.items():
        assert sd[name].shape == list(a.shape), name
        np.testing.assert_array_equal(sd[name].numpy(), a)
    assert tm.blocks[0].attn.qkv_proj.weight.shape == [64, 192]


def test_logits_match_jax(pair):
    got, want = pair["tlogits"].numpy(), np.asarray(pair["jlogits"])
    assert got.shape == (2, 16, VOCAB)
    assert (np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)).all(), \
        float(np.abs(got - want).max())


def test_loss_matches_jax(pair):
    np.testing.assert_allclose(pair["tloss"].item(), pair["jloss"],
                               rtol=LOSS_RTOL)


def test_gradients_match_jax(pair):
    tm, jgrads = pair["tm"], pair["jgrads"]
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        ref = jgrads[name]
        err = np.abs(p.grad.numpy() - ref)
        assert (err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref)).all(), \
            (name, float(err.max()))


def test_one_adamw_step_matches_jax(pair):
    """The JAX AdamW (its per-parameter loop, ``FLAGS_fused_optimizer``
    off) and the port's AdamW over the port's Parameters, both from the
    JAX gradients (the gradients are held to each other above: Adam's
    first step divides each by its own magnitude, so a gradient near 0
    on one side and near -0 on the other would move its parameter by
    ±lr)."""
    jm, tm, jgrads = pair["jm"], pair["tm"], pair["jgrads"]
    prev = jpaddle.get_flags("FLAGS_fused_optimizer")
    jpaddle.set_flags({"FLAGS_fused_optimizer": 0})
    try:
        jopt = jpaddle.optimizer.AdamW(learning_rate=LR,
                                       parameters=jm.parameters())
        for name, p in jm.named_parameters():
            p.grad = jpaddle.to_tensor(jgrads[name])
        jopt.step()
    finally:
        jpaddle.set_flags(prev)
    topt = tpaddle.optimizer.AdamW(learning_rate=LR,
                                   parameters=tm.parameters())
    for name, p in tm.named_parameters():
        p.grad = tpaddle.to_tensor(jgrads[name])
    topt.step()
    topt.clear_grad()
    assert all(p.grad is None for p in tm.parameters())
    for (name, jp), (_, tp) in zip(jm.named_parameters(),
                                   tm.named_parameters()):
        ref = np.asarray(jp._data)
        err = np.abs(tp.numpy() - ref)
        assert (err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref)).all(), \
            (name, float(err.max()))
        assert not np.array_equal(tp.numpy(), pair["arrays"][name])


def test_port_gpt_trains_eagerly_on_the_cpu():
    """The eager paddle loop of the chip phase at a tiny size: loss
    falling over a few AdamW steps."""
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    tdevice.set_device("cpu")
    try:
        tpaddle.seed(0)
        model = GPTForCausalLM(GPTConfig.tiny(use_flash_attention=True))
        opt = tpaddle.optimizer.AdamW(learning_rate=3e-3,
                                      parameters=model.parameters(),
                                      multi_precision=False)
        crit = tpaddle.nn.CrossEntropyLoss()
        ids = tpaddle.to_tensor(_ids())
        losses = []
        for _ in range(4):
            loss = crit(model(ids).reshape([-1, VOCAB]), ids.reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert isinstance(model.blocks[0].attn.qkv_proj.weight._t,
                          torch.nn.Parameter)
    finally:
        tdevice._current = prev

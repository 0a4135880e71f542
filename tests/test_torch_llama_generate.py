"""The rest of the port's Llama against the JAX model, on the CPU:
``LlamaConfig.recompute`` (gradients bit-equal to the run without it,
and within 1e-4 of the JAX model's; the JAX side runs without recompute:
its eager ``jax.checkpoint`` path gives gradients that depend on what
ran before it in the process), the cache path (``forward(
caches=)`` step by step equal to the full forward, and each step's
logits and K/V caches equal to the JAX model's; caches kept before the
GQA repeat) and greedy ``generate`` (the JAX model's ids from the
same weights: 2 layers, GQA 4/2, f32). Sequence parallelism and the
context-parallel mesh raise, naming their ROADMAP item.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.jit.api import functionalize
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          LlamaPretrainingCriterion)
from test_torch_tensor import port_on_cpu  # noqa: F401

GRAD_TOL = 1e-4     # relative to the largest gradient of the tensor
STEP_TOL = 1e-5


def _pair(seed=3, **kw):
    jpaddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**kw))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_from_jax(tm, arrays)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _read_only_pair(seed):
    """``_pair(seed)`` shared by the tests that only read the models
    (the JAX side's eager compiles are then paid once a shape)."""
    return _pair(seed)


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int64)


def _torch_grads(tm, ids):
    t = torch.from_numpy(ids)
    loss = LlamaPretrainingCriterion()(tm(t), t)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return float(loss), grads


def test_recompute_gradients_equal_plain_and_jax():
    jm, tm = _pair()
    tm.config.recompute = True
    ids = _ids((2, 16))
    fwd, params, buffers = functionalize(jm)
    crit = JaxCriterion()

    def loss_fn(p):
        logits = fwd(p, buffers, jnp.asarray(ids))[0]
        return crit(jpaddle.Tensor(logits),
                    jpaddle.Tensor(jnp.asarray(ids)))._data
    # the JAX package's lazy fusion, tracing under jax.jit, leaves state
    # that breaks later traces in the process (test_pipeline_tied.py's
    # tied gradients): the JAX side traces with it off
    fusion = jpaddle.get_flags("FLAGS_eager_fusion")
    jpaddle.set_flags({"FLAGS_eager_fusion": False})
    try:
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        jpaddle.set_flags(fusion)
    jgrads = {n: np.asarray(g) for n, g in jgrads.items()}
    assert tm.config.recompute
    loss_r, grads_r = _torch_grads(tm, ids)
    tm.config.recompute = False
    loss_p, grads_p = _torch_grads(tm, ids)
    assert loss_r == loss_p
    np.testing.assert_allclose(loss_r, float(jloss), rtol=1e-5)
    for name, g in grads_r.items():
        assert torch.equal(g, grads_p[name]), name
        want = jgrads[name]
        got = g.numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            got = got.T                        # [out, in] -> JAX [in, out]
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_recompute_runs_each_block_forward_twice():
    """Under recompute the backward runs each decoder block's forward
    again (the flash entry included); without gradients it runs once."""
    _, tm = _pair(recompute=True, use_flash_attention=True)
    calls = []
    hooks = [layer.self_attn.register_forward_hook(
        lambda *a: calls.append(1)) for layer in tm.llama.layers]
    ids = torch.from_numpy(_ids((1, 8)))
    LlamaPretrainingCriterion()(tm(ids), ids).backward()
    assert len(calls) == 2 * tm.config.num_hidden_layers
    calls.clear()
    with torch.no_grad():
        tm(ids)
    assert len(calls) == tm.config.num_hidden_layers
    for h in hooks:
        h.remove()


def test_cache_steps_equal_the_full_forward():
    _, tm = _pair()
    ids = torch.from_numpy(_ids((2, 12), seed=1))
    with torch.no_grad():
        full = tm(ids)
        n = tm.config.num_hidden_layers
        logits, caches = tm(ids[:, :5], caches=[(None, None)] * n)
        steps = [logits]
        for i in range(5, 12):
            logits, caches = tm(ids[:, i:i + 1], caches=caches,
                                position_offset=i)
            steps.append(logits)
    got = torch.cat(steps, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=STEP_TOL,
                               rtol=0)
    kv = tm.config.num_key_value_heads
    hd = tm.config.hidden_size // tm.config.num_attention_heads
    assert len(caches) == n
    for k, v in caches:
        assert tuple(k.shape) == tuple(v.shape) == (2, 12, kv, hd)


def test_cache_steps_equal_the_jax_steps():
    """The cache path against the JAX model's: a 5-token prefill with
    empty caches, then two one-token steps at ``position_offset`` 5 and
    6. Each step's logits and every layer's K/V cache (kept before
    the GQA repeat) agree with JAX's."""
    jm, tm = _read_only_pair(5)
    ids = np.concatenate([_ids((2, 5), seed=2), _ids((2, 2), seed=6)], 1)
    n = tm.config.num_hidden_layers
    jcaches = [(None, None)] * n
    tcaches = [(None, None)] * n
    with jpaddle.no_grad(), torch.no_grad():
        for lo, hi in ((0, 5), (5, 6), (6, 7)):
            jlogits, jcaches = jm(jpaddle.to_tensor(ids[:, lo:hi]),
                                  caches=jcaches, position_offset=lo)
            tlogits, tcaches = tm(torch.from_numpy(ids[:, lo:hi]),
                                  caches=tcaches, position_offset=lo)
            np.testing.assert_allclose(tlogits.numpy(),
                                       np.asarray(jlogits._data),
                                       atol=STEP_TOL, rtol=0, err_msg=lo)
            assert len(tcaches) == len(jcaches) == n
            for (tk, tv), (jk, jv) in zip(tcaches, jcaches):
                assert tuple(tk.shape) == np.asarray(jk._data).shape
                np.testing.assert_allclose(tk.numpy(), np.asarray(jk._data),
                                           atol=STEP_TOL, rtol=0)
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv._data),
                                           atol=STEP_TOL, rtol=0)


def test_generate_gives_the_jax_ids():
    jm, tm = _read_only_pair(5)
    prompt = _ids((2, 5), seed=2)
    # greedy ids are prefix-consistent: JAX's first new id and its one
    # decode step (its eager decode compiles every step's shapes) against
    # the first of the port's 6; the port's later ids are held to the
    # teacher-forced argmax below
    with jpaddle.no_grad():         # the step test's compiles serve here
        jids = np.asarray(jm.generate(jpaddle.to_tensor(prompt), 1)._data)
    tids = tm.generate(torch.from_numpy(prompt), 6)
    assert tids.shape == (2, 11)
    np.testing.assert_array_equal(tids[:, :6].numpy(), jids)
    # teacher-forced: each new id is the argmax of one cache-free forward
    with torch.no_grad():
        full = tm(tids)
    np.testing.assert_array_equal(full[:, 4:10].argmax(-1).numpy(),
                                  tids[:, 5:].numpy())


@pytest.mark.parametrize("field", ["sequence_parallel", "cp_mesh"])
def test_unported_parallelism_raises(field):
    with pytest.raises(NotImplementedError, match="item 13"):
        LlamaConfig.tiny(**{field: True if field != "cp_mesh" else object()})

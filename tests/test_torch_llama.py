"""The port's Llama module tree against the JAX model: weights carried
across with convert.state_dict_from_jax, cache-free logits within f32
atol 1e-4 (same math; XLA and PyTorch sum in other orders)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas.flash_attention import _sdpa_xla
from paddle_tpu_torch.convert import (load_from_jax, state_dict_from_jax)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import sdpa_reference

ATOL = 1e-4


def _pair(seed=7, **kw):
    cfg = dict(use_flash_attention=False, **kw)
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**cfg))
    arrays = {k: np.asarray(v._data) for k, v in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_from_jax(tm, arrays)
    return jm, tm, arrays


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jax_logits(jm, ids, **kw):
    return np.asarray(jm(paddle.to_tensor(ids), **kw)._data)


def _torch_logits(tm, ids, **kw):
    with torch.no_grad():
        return tm(torch.as_tensor(ids), **kw).numpy()


def test_state_dict_names_and_layouts(pair):
    jm, tm, arrays = pair
    sd = tm.state_dict()
    assert set(sd) == set(arrays)
    conv = state_dict_from_jax(arrays)
    for name, a in arrays.items():
        linear = name.split(".")[-2] in ("q_proj", "k_proj", "v_proj",
                                         "o_proj", "gate_proj", "up_proj",
                                         "down_proj", "lm_head")
        want = a.T if linear else a
        assert tuple(sd[name].shape) == want.shape, name
        np.testing.assert_array_equal(conv[name].numpy(), want)
        np.testing.assert_array_equal(sd[name].numpy(), want)


@pytest.mark.parametrize("seq", [1, 7])
def test_cache_free_logits_match_jax(pair, seq):
    jm, tm, _ = pair
    ids = np.random.default_rng(seq).integers(0, 128, (2, seq))
    np.testing.assert_allclose(_torch_logits(tm, ids),
                               _jax_logits(jm, ids), atol=ATOL, rtol=0)


def test_position_offset_and_additive_mask_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.default_rng(1).integers(0, 128, (2, 6))
    np.testing.assert_allclose(
        _torch_logits(tm, ids, position_offset=5),
        _jax_logits(jm, ids, position_offset=5), atol=ATOL, rtol=0)
    mask = np.zeros((2, 1, 6, 6), np.float32)
    mask[1, :, :, 0] = -1e9                      # slot 1 ignores token 0
    np.testing.assert_allclose(
        _torch_logits(tm, ids, attention_mask=torch.from_numpy(mask)),
        _jax_logits(jm, ids, attention_mask=paddle.to_tensor(mask)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(tie_word_embeddings=True),
                                dict(num_key_value_heads=4),
                                dict(num_key_value_heads=1)],
                         ids=["tied", "mha", "mqa"])
def test_variants_match_jax(kw):
    jm, tm, arrays = _pair(seed=3, **kw)
    if kw.get("tie_word_embeddings"):
        assert "lm_head.weight" not in arrays
    ids = np.random.default_rng(2).integers(0, 128, (1, 9))
    np.testing.assert_allclose(_torch_logits(tm, ids),
                               _jax_logits(jm, ids), atol=ATOL, rtol=0)


def test_flash_flag_on_cpu_runs_the_plain_sdpa(pair):
    """On the CPU the flag routes attention through the flash entry's
    plain walk (the kernels' counterpart), which agrees with the plain
    sdpa within f32 summation order; the kernels run only for CUDA
    tensors."""
    _, tm, arrays = pair
    flash = LlamaForCausalLM(LlamaConfig.tiny(use_flash_attention=True),
                             device="cpu")
    load_from_jax(flash, arrays)
    ids = np.random.default_rng(4).integers(0, 128, (1, 5))
    np.testing.assert_allclose(_torch_logits(flash, ids),
                               _torch_logits(tm, ids), atol=1e-5, rtol=0)


def test_init_scales_follow_the_jax_initializers():
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           vocab_size=1024)
    m = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    q = m.llama.layers[0].self_attn.q_proj.weight
    assert abs(q.std().item() - math.sqrt(2 / 512)) < 0.1 * math.sqrt(
        2 / 512)
    assert abs(m.llama.embed_tokens.weight.std().item() - 0.02) < 0.002
    assert torch.equal(m.llama.norm.weight, torch.ones(256))
    again = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, again.llama.layers[0].self_attn.q_proj.weight)
    bf = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"), device="cpu")
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="dtype"):
        LlamaForCausalLM(LlamaConfig.tiny(dtype="float16"), device="cpu")


@pytest.mark.parametrize("lq,lk,causal,masked", [
    (5, 5, True, False), (3, 8, True, False), (4, 4, False, True)])
def test_sdpa_reference_matches_the_jax_oracle(lq, lk, causal, masked):
    rng = np.random.default_rng(lq * 10 + lk)
    q = rng.standard_normal((2, lq, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, lk, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, lk, 3, 8)).astype(np.float32)
    mask = (rng.standard_normal((2, 1, lq, lk)).astype(np.float32)
            if masked else None)
    import jax.numpy as jnp
    want = np.asarray(_sdpa_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask)))
    got = sdpa_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

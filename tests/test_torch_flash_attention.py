"""The port's flash attention against the JAX package's, on the CPU.

The JAX kernel bodies (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) run through ``pl.pallas_call(..., interpret=True)``
with the launchers' BlockSpecs; the port's plain versions (what a CPU
tensor takes, and the CUDA kernels' oracles) must match them within
f32 atol 1e-5 (same algebra; the walks tile and sum in other orders).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn.functional import (flash_attention as
                                            paddle_flash_attention,
                                            scaled_dot_product_attention,
                                            sdpa_reference)
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 1e-5
BH, L, BLOCK = 2, 256, 128


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(4)]


def _jax_fwd(q, k, v, causal, scale):
    """``_flash_fwd_pallas``'s call (:380-396), interpreted."""
    bh, n, d = q.shape
    kern = functools.partial(jfa._fwd_kernel, block_q=BLOCK, block_k=BLOCK,
                             seq_len=n, causal=causal, scale=scale)
    return pl.pallas_call(
        kern, grid=(bh, n // BLOCK),
        in_specs=[pl.BlockSpec((1, BLOCK, d), lambda b, i: (b, i, 0)),
                  pl.BlockSpec((1, n, d), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((1, n, d), lambda b, i: (b, 0, 0))],
        out_specs=[pl.BlockSpec((1, BLOCK, d), lambda b, i: (b, i, 0)),
                   pl.BlockSpec((1, BLOCK, 1), lambda b, i: (b, i, 0))],
        out_shape=[jax.ShapeDtypeStruct((bh, n, d), q.dtype),
                   jax.ShapeDtypeStruct((bh, n, 1), jnp.float32)],
        interpret=True)(q, k, v)


def _jax_bwd(q, k, v, do, lse, delta, causal, scale):
    """``_flash_bwd_pallas``'s two calls (:414-451), interpreted."""
    bh, n, d = q.shape
    kw = dict(block_q=BLOCK, block_k=BLOCK, seq_len=n, causal=causal,
              scale=scale)
    blk = pl.BlockSpec((1, BLOCK, d), lambda b, i: (b, i, 0))
    seq = pl.BlockSpec((1, n, d), lambda b, i: (b, 0, 0))
    r_blk = pl.BlockSpec((1, BLOCK, 1), lambda b, i: (b, i, 0))
    r_seq = pl.BlockSpec((1, n, 1), lambda b, i: (b, 0, 0))
    dq = pl.pallas_call(
        functools.partial(jfa._bwd_dq_kernel, **kw),
        grid=(bh, n // BLOCK),
        in_specs=[blk, seq, seq, blk, r_blk, r_blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((bh, n, d), q.dtype),
        interpret=True)(q, k, v, do, lse, delta)
    dk, dv = pl.pallas_call(
        functools.partial(jfa._bwd_dkv_kernel, **kw),
        grid=(bh, n // BLOCK),
        in_specs=[seq, blk, blk, seq, r_seq, r_seq],
        out_specs=[blk, blk],
        out_shape=[jax.ShapeDtypeStruct((bh, n, d), k.dtype),
                   jax.ShapeDtypeStruct((bh, n, d), v.dtype)],
        interpret=True)(q, k, v, do, lse, delta)
    return dq, dk, dv


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_forward_matches_the_jax_kernel(d, causal):
    q, k, v, _ = _qkv(d + causal, (BH, L, d))
    scale = 1.0 / math.sqrt(d)
    out_j, lse_j = _jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, scale)
    out_t, lse_t = tfa.flash_attention_fwd_reference(*_t(q, k, v), causal)
    assert lse_t.shape == (BH, L)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               atol=ATOL, rtol=0)
    # the wrapper takes the plain walk for CPU tensors, counting nothing
    before = tfa.flash_attention_fwd.launches
    out_w, lse_w = tfa.flash_attention_fwd(*_t(q, k, v), causal, scale)
    assert tfa.flash_attention_fwd.launches == before
    assert torch.equal(out_w, out_t) and torch.equal(lse_w, lse_t)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_backward_matches_the_jax_kernels(d, causal):
    q, k, v, do = _qkv(10 + d, (BH, L, d))
    scale = 1.0 / math.sqrt(d)
    qj, kj, vj, doj = (jnp.asarray(a) for a in (q, k, v, do))
    out_j, lse_j = _jax_fwd(qj, kj, vj, causal, scale)
    delta_j = jnp.sum(doj * out_j, axis=-1, keepdims=True)
    want = _jax_bwd(qj, kj, vj, doj, lse_j, delta_j, causal, scale)
    # the port's parts on the JAX forward's residuals ...
    lse, delta = _t(np.asarray(lse_j)[..., 0], np.asarray(delta_j)[..., 0])
    qt, kt, vt, dot = _t(q, k, v, do)
    dq = tfa.flash_attention_bwd_dq_reference(qt, kt, vt, dot, lse, delta,
                                              causal)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(qt, kt, vt, dot, lse,
                                                   delta, causal)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    # ... and the whole plain backward on the port's own forward
    out_t, lse_t = tfa.flash_attention_fwd_reference(qt, kt, vt, causal)
    np.testing.assert_allclose(
        tfa.attention_delta(out_t, dot).numpy(),
        np.asarray(delta_j)[..., 0], atol=ATOL, rtol=0)
    for got, ref in zip(tfa.flash_attention_bwd_reference(
            qt, kt, vt, out_t, lse_t, dot, causal), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("n,causal", [(40, True), (40, False), (1, True),
                                      (130, True)])
def test_public_entry_matches_jax_vjp_any_length(n, causal):
    """[B, L, H, D] with L not a multiple of the tile: the port masks the
    ragged tail (the JAX entry takes its XLA path there). Values and
    gradients against jax.vjp of the JAX flash_attention."""
    q, k, v, do = _qkv(n, (2, n, 3, 64))
    want_out, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal, None),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)
    for x, ref in zip((qt, kt, vt), want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)


def test_three_d_layout_is_the_four_d_layout_with_one_head():
    q, k, v, do = _qkv(3, (3, 70, 64))
    qt, kt, vt, dot = _t(q, k, v, do)
    out3, lse3 = tfa.flash_attention_fwd_reference(qt, kt, vt, True)
    out4, lse4 = tfa.flash_attention_fwd_reference(
        *(x[:, :, None] for x in (qt, kt, vt)), True)
    assert out3.shape == (3, 70, 64) and lse3.shape == (3, 70)
    torch.testing.assert_close(out3, out4[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(lse3, lse4[:, 0], rtol=0, atol=0)
    g3 = tfa.flash_attention_bwd_reference(qt, kt, vt, out3, lse3, dot, True)
    g4 = tfa.flash_attention_bwd_reference(
        *(x[:, :, None] for x in (qt, kt, vt, out3)), lse3[:, None],
        dot[:, :, None], True)
    for a, b in zip(g3, g4):
        torch.testing.assert_close(a, b[:, :, 0], rtol=0, atol=0)


def test_autograd_gradcheck_f64():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 4)))
               .requires_grad_() for _ in range(3))
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.FlashAttention.apply(a, b, c, causal, None),
            (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_autograd_f32_matches_autograd_through_sdpa_reference(causal):
    q, k, v, do = _qkv(7, (2, 33, 4, 64))
    grads = []
    for fn in (lambda a, b, c: tfa.flash_attention(a, b, c, causal),
               lambda a, b, c: sdpa_reference(a, b, c, causal=causal)):
        xs = [x.requires_grad_() for x in _t(q, k, v)]
        out = fn(*xs)
        out.backward(torch.from_numpy(do))
        grads.append([out.detach()] + [x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_functional_entries_route_by_mask_and_refuse_dropout():
    q, k, v, _ = _qkv(8, (1, 12, 2, 64))
    qt, kt, vt = _t(q, k, v)
    flash = tfa.flash_attention_fwd_reference(qt, kt, vt, True)[0]
    out = scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    assert torch.equal(out, flash)
    out2, sm = paddle_flash_attention(qt, kt, vt, causal=True)
    assert sm is None and torch.equal(out2, flash)
    mask = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 12, 12)).astype(np.float32))
    torch.testing.assert_close(
        scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        sdpa_reference(qt, kt, vt, mask=mask), rtol=0, atol=0)
    # dropout only off in eval, as the paddle API
    torch.testing.assert_close(
        scaled_dot_product_attention(qt, kt, vt, dropout_p=0.5,
                                     training=False),
        tfa.flash_attention_fwd_reference(qt, kt, vt)[0], rtol=0, atol=0)
    for call in (lambda: tfa.flash_attention(qt, kt, vt, dropout_p=0.1),
                 lambda: scaled_dot_product_attention(qt, kt, vt,
                                                      dropout_p=0.1),
                 lambda: paddle_flash_attention(qt, kt, vt, dropout=0.1)):
        with pytest.raises(NotImplementedError, match="K5"):
            call()

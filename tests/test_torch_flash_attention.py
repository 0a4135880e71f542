"""The port's flash attention against the JAX package's, on the CPU.

The JAX kernel bodies (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) run through ``pl.pallas_call(..., interpret=True)``
with the launchers' BlockSpecs — plain, with dropout (fed the port's
keep mask) and segmented; the port's plain versions (what a CPU tensor
takes, and the CUDA kernels' oracles) must match them within f32 atol
1e-5 (same algebra; the walks tile and sum in other orders).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.nn.functional.attention import \
    flash_attn_varlen_qkvpacked as jax_varlen
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.nn.functional import (flash_attention as
                                            paddle_flash_attention,
                                            scaled_dot_product_attention,
                                            sdpa_reference)
from paddle_tpu_torch.nn.functional import \
    flash_attn_varlen_qkvpacked as varlen_qkvpacked
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread while this file's tests run. Its f64 gradcheck
    makes thousands of calls on tensors of a few hundred elements;
    beside the other workers of a parallel run, torch's intra-op threads
    oversubscribe the cores and each call slows ~100x (six copies of
    the gradcheck at once: 733 s each with 8 threads, 6.5 s with one),
    which pushed the whole tier-1 run past its time limit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
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
    """No mask: the flash kernels (plain versions here); a mask: the
    plain sdpa. Dropout is on only in training and routes to the kernels
    with a key drawn from the port's key stream (the masked route draws
    the same key and the same keep mask); dropout without a seed, or
    at p >= 1, is refused by the kernel entry."""
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
    state = trandom.get_rng_state()
    seed = trandom.next_key("cpu")
    trandom.set_rng_state(state)
    drop = scaled_dot_product_attention(qt, kt, vt, dropout_p=0.3)
    want = tfa.flash_attention_fwd_reference(qt, kt, vt, False, None, 0.3,
                                             seed)[0]
    assert torch.equal(drop, want)
    assert not torch.equal(drop, tfa.flash_attention_fwd_reference(
        qt, kt, vt)[0])
    trandom.set_rng_state(state)
    masked = scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          dropout_p=0.3)
    torch.testing.assert_close(
        masked, sdpa_reference(qt, kt, vt, mask=mask, dropout_p=0.3,
                               seed=seed), rtol=0, atol=0)
    trandom.set_rng_state(state)
    out3, _ = paddle_flash_attention(qt, kt, vt, dropout=0.3)
    assert torch.equal(out3, want)
    with pytest.raises(ValueError, match="needs a seed"):
        tfa.flash_attention(qt, kt, vt, dropout_p=0.1)
    with pytest.raises(ValueError, match="< 1"):
        tfa.flash_attention(qt, kt, vt, dropout_p=1.0, seed=1)
    assert not scaled_dot_product_attention(qt, kt, vt,
                                            dropout_p=1.0).any()


# -- dropout (K5) and segments (K4) ------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                            0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    got = tfa.philox4x32_10([torch.tensor([c]) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


def _keep_for_jax(seed, bh, n, p):
    """The port's keep mask as int32 [BH, L, L]: fed to the JAX kernel
    bodies in place of their SMEM seed, and cut to the tile by the
    patched ``_keep_mask`` below."""
    return tfa.flash_dropout_keep_mask(seed, bh, 1, n, p)[:, 0].numpy(
    ).astype(np.int32)


def _tile_of_port_mask(mask_ref, b, qi, ki, block_q, block_k, seq_len,
                       dropout_p):
    return mask_ref[0, pl.ds(qi * block_q, block_q),
                    pl.ds(ki * block_k, block_k)] != 0


def _jax_calls(q, k, v, do, causal, scale, lead=None, lead_spec=None,
               tail=None, tail_spec=None, **kw):
    """``_flash_fwd_pallas`` then ``_flash_bwd_pallas`` (or their
    segmented twins), interpreted: ``lead`` is an extra first input (the
    dropout seed slot), ``tail`` an extra last input (the segment ids)."""
    bh, n, d = q.shape
    kw = dict(block_q=BLOCK, block_k=BLOCK, seq_len=n, causal=causal,
              scale=scale, **kw)
    blk = pl.BlockSpec((1, BLOCK, d), lambda b, i: (b, i, 0))
    seq = pl.BlockSpec((1, n, d), lambda b, i: (b, 0, 0))
    r_blk = pl.BlockSpec((1, BLOCK, 1), lambda b, i: (b, i, 0))
    r_seq = pl.BlockSpec((1, n, 1), lambda b, i: (b, 0, 0))
    head = [lead] if lead is not None else []
    hspec = [lead_spec] if lead is not None else []
    end = [tail] if tail is not None else []
    espec = [tail_spec] if tail is not None else []
    out, lse = pl.pallas_call(
        functools.partial(jfa._fwd_kernel, **kw), grid=(bh, n // BLOCK),
        in_specs=hspec + [blk, seq, seq] + espec,
        out_specs=[blk, r_blk],
        out_shape=[jax.ShapeDtypeStruct((bh, n, d), q.dtype),
                   jax.ShapeDtypeStruct((bh, n, 1), jnp.float32)],
        interpret=True)(*head, q, k, v, *end)
    delta = jnp.sum(do * out, axis=-1, keepdims=True)
    dq = pl.pallas_call(
        functools.partial(jfa._bwd_dq_kernel, **kw), grid=(bh, n // BLOCK),
        in_specs=hspec + [blk, seq, seq, blk, r_blk, r_blk] + espec,
        out_specs=blk, out_shape=jax.ShapeDtypeStruct((bh, n, d), q.dtype),
        interpret=True)(*head, q, k, v, do, lse, delta, *end)
    dk, dv = pl.pallas_call(
        functools.partial(jfa._bwd_dkv_kernel, **kw), grid=(bh, n // BLOCK),
        in_specs=hspec + [seq, blk, blk, seq, r_seq, r_seq] + espec,
        out_specs=[blk, blk],
        out_shape=[jax.ShapeDtypeStruct((bh, n, d), k.dtype),
                   jax.ShapeDtypeStruct((bh, n, d), v.dtype)],
        interpret=True)(*head, q, k, v, do, lse, delta, *end)
    return out, lse, delta, dq, dk, dv


def _port_parts(q, k, v, do, causal, scale, **kw):
    qt, kt, vt, dot = _t(q, k, v, do)
    out, lse = tfa.flash_attention_fwd_reference(qt, kt, vt, causal, scale,
                                                 **kw)
    delta = tfa.attention_delta(out, dot)
    dq = tfa.flash_attention_bwd_dq_reference(qt, kt, vt, dot, lse, delta,
                                              causal, scale, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(qt, kt, vt, dot, lse,
                                                   delta, causal, scale,
                                                   **kw)
    return out, lse, delta, dq, dk, dv


def _assert_parts(port, jax_parts):
    for got, ref in zip(port, jax_parts):
        ref = np.asarray(ref)
        ref = ref[..., 0] if ref.ndim == 3 and ref.shape[-1] == 1 else ref
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_dropout_algebra_matches_the_jax_kernel_bodies(causal, monkeypatch):
    """K5: the port's plain forward, dQ and dK/dV with dropout against
    ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` with
    ``dropout_p > 0``, interpreted, fed the same random numbers: the
    JAX ``_keep_mask`` is replaced by the port's Philox mask cut to the
    tile (the TPU's own bits exist only on a TPU)."""
    q, k, v, do = _qkv(20 + causal, (BH, L, 64))
    seed, p, scale = 0x0123456789ABCDEF, 0.2, 0.125
    monkeypatch.setattr(jfa, "_keep_mask", _tile_of_port_mask)
    mask = _keep_for_jax(seed, BH, L, p)
    want = _jax_calls(*(jnp.asarray(a) for a in (q, k, v, do)), causal,
                      scale, lead=mask,
                      lead_spec=pl.BlockSpec((1, L, L), lambda b, i:
                                             (b, 0, 0)),
                      dropout_p=p)
    _assert_parts(_port_parts(q, k, v, do, causal, scale, dropout_p=p,
                              seed=seed), want)


def test_keep_mask_rate_seeds_and_tiles():
    """The keep rate is within 4 sigma of 1 - p; two seeds differ; the
    mask is a function of (seed, b, h, row, col) whatever the tile: any
    sub-block drawn alone equals the same block of the whole mask."""
    B, H, n, p = 2, 3, 200, 0.1
    keep = tfa.flash_dropout_keep_mask(7, B, H, n, p)
    assert keep.shape == (B, H, n, n) and keep.dtype == torch.bool
    sigma = math.sqrt(p * (1 - p) / keep.numel())
    assert abs(keep.float().mean().item() - (1 - p)) <= 4 * sigma
    assert not torch.equal(keep, tfa.flash_dropout_keep_mask(8, B, H, n, p))
    rows = torch.arange(37, 101)
    tile = tfa._keep_tile(7, B, H, rows, 13, 50, tfa.dropout_threshold(p))
    assert torch.equal(tile, keep[:, :, 37:101, 13:63])
    assert tfa.dropout_threshold(0.1) == int(0.1 * 2 ** 32)
    assert tfa.dropout_threshold(1.0) == 2 ** 32 - 1


def test_zero_dropout_is_the_no_dropout_call():
    q, k, v, do = _t(*_qkv(30, (2, 70, 3, 64)))
    for causal in (True, False):
        base = tfa.flash_attention_fwd_reference(q, k, v, causal)
        zero = tfa.flash_attention_fwd_reference(q, k, v, causal, None, 0.0,
                                                 123)
        for a, b in zip(base, zero):
            assert torch.equal(a, b)
        out, lse = base
        g0 = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        g1 = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                               None, 0.0, 123)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b)


def _segments(n, lengths):
    ids = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    assert ids.size == n
    return ids


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_segmented_plain_versions_match_the_jax_segmented_kernels(causal):
    """K4: the plain versions with segment ids against ``_fwd_kernel``
    and the backward kernels with ``segmented=True``, built as
    ``_flash_fwd_pallas_seg`` / ``_flash_bwd_pallas_seg`` build their
    calls (seg repeated per head as ``[BH, L, 1]``). The first query
    tile of the second sequence starts mid-tile: its first KV columns
    all belong to another segment."""
    q, k, v, do = _qkv(40 + causal, (BH, L, 64))
    seg = np.stack([_segments(L, [100, 60, 96]),
                    _segments(L, [7, 249])])
    seg3 = seg[:, :, None]
    want = _jax_calls(*(jnp.asarray(a) for a in (q, k, v, do)), causal,
                      0.125, tail=jnp.asarray(seg3),
                      tail_spec=pl.BlockSpec((1, L, 1),
                                             lambda b, i: (b, 0, 0)),
                      segmented=True)
    _assert_parts(_port_parts(q, k, v, do, causal, 0.125,
                              seg=torch.from_numpy(seg)), want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_segmented_entry_matches_jax_vjp(causal):
    """``flash_attention_segmented`` against the JAX entry on the CPU
    (its XLA path), values and gradients, at a ragged length."""
    n = 90
    q, k, v, do = _qkv(50 + causal, (2, n, 3, 64))
    seg = np.stack([_segments(n, [30, 45, 15]), _segments(n, [90])])
    want, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_segmented(
            a, b, c, jnp.asarray(seg), causal, None),
        *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    out = tfa.flash_attention_segmented(*xs, torch.from_numpy(seg), causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for x, ref in zip(xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_varlen_qkvpacked_matches_the_jax_entry(causal):
    """``flash_attn_varlen_qkvpacked`` (cu_seqlens -> segment ids, q/k/v
    read as strided views of the packed tensor) against the JAX entry:
    output and the gradient of the packed qkv."""
    lengths = [5, 40, 1, 34]
    total = sum(lengths)
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    rng = np.random.default_rng(60 + causal)
    qkv = rng.standard_normal((total, 3, 2, 64)).astype(np.float32)
    g = rng.standard_normal((total, 2, 64)).astype(np.float32)
    jt = paddle.to_tensor(qkv, stop_gradient=False)
    jcu = paddle.to_tensor(cu)
    jout, jsm = jax_varlen(jt, jcu, jcu, None, None, None, causal=causal)
    (jout * paddle.to_tensor(g)).sum().backward()
    t = torch.from_numpy(qkv).requires_grad_()
    tcu = torch.from_numpy(cu)
    out, sm = varlen_qkvpacked(t, tcu, tcu, None, None, None, causal=causal)
    out.backward(torch.from_numpy(g))
    assert sm is None and jsm is None and out.shape == (total, 2, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt.grad._data),
                               atol=ATOL, rtol=0)
    # dropout is accepted and unused, as the JAX entry does
    again, _ = varlen_qkvpacked(t.detach(), tcu, tcu, None, None, None,
                                dropout=0.5, causal=causal)
    assert torch.equal(again, out.detach())
    with pytest.raises(ValueError, match="cu_seqlens_k differs"):
        varlen_qkvpacked(t.detach(), tcu, tcu.flip(0), None, None, None)


def test_autograd_gradcheck_f64_with_dropout_and_segments():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 11, 2, 4)))
               .requires_grad_() for _ in range(3))
    seg = torch.tensor([[0] * 4 + [1] * 7, [0] * 11], dtype=torch.int32)
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.FlashAttention.apply(
                a, b, c, causal, None, 0.3, torch.tensor([99, 0]), None),
            (q, k, v), eps=1e-6, atol=1e-6)
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.flash_attention_segmented(a, b, c, seg,
                                                          causal),
            (q, k, v), eps=1e-6, atol=1e-6)

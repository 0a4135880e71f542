"""Tests of the port that need the card: the Hopper paged-attention
kernel against its plain walk, a tiny engine through the kernel against
the same engine through the walk, the three flash-attention kernels
against their plain versions (plain, with dropout and with segments;
bf16 at head dim 128 on the TMA / wgmma kernels, everything else on the
first design, by their counts),
a tiny Llama train step through them against the same step through
the plain sdpa, the grouped-matmul kernels (K6 forward and dlhs, K7
drhs; TMA / wgmma for bf16 with 16-byte rows, the general kernels
otherwise, by their counts) against their plain versions and the op's
autograd against the dense oracle's, and a tiny ERNIE-MoE step. Each skips (with its reason)
where there is no CUDA device; the decision is made inside the
fixture, never at import. This file imports no JAX, so on a machine
without it run it as

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.ernie_moe import (ErnieMoEConfig,
                                               ErnieMoEForCausalLM)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import grouped_matmul as tgmm
from paddle_tpu_torch.ops.kernels import paged_attention as tpk
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import GenerationServer, PagedLlamaDecodeEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, S, T, H, K, D, bs, MB, dtype, quant, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = S * MB + 1
    q = torch.randn((S, T, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((NB, bs, K, D), generator=g, device=dev)
    vp = torch.randn((NB, bs, K, D), generator=g, device=dev)
    tables = torch.randperm(NB, generator=g, device=dev)[:S * MB]
    tables = tables.view(S, MB).to(torch.int32).contiguous()
    tables[0, -1] = -1
    last = torch.randint(T - 1, bs * (MB - 1), (S, 1), generator=g,
                         device=dev)
    pos = (last - T + 1 + torch.arange(T, device=dev)).to(torch.int32)
    kw = dict(block_size=bs, n_rep=H // K)
    if quant:
        from paddle_tpu_torch.serving_cache import absmax_quantize
        kq, ks = absmax_quantize(kp.view(-1, K, D))
        vq, vs = absmax_quantize(vp.view(-1, K, D))
        kp, vp = kq.view(NB, bs, K, D), vq.view(NB, bs, K, D)
        kw.update(k_scale=ks.view(NB, bs, K), v_scale=vs.view(NB, bs, K))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q, kp, vp, tables, pos), kw


@pytest.mark.parametrize("dtype,quant,tol", [
    (torch.float32, False, 1e-4), (torch.float32, True, 1e-4),
    (torch.bfloat16, False, 2e-2), (torch.bfloat16, True, 2e-2)],
    ids=["f32", "f32-int8", "bf16", "bf16-int8"])
@pytest.mark.parametrize("geo", [(3, 1, 8, 2, 64, 16, 6),
                                 (2, 7, 8, 8, 128, 8, 5),
                                 (1, 40, 4, 1, 128, 32, 3)],
                         ids=["decode-gqa", "verify-mha", "chunk-mqa"])
def test_kernel_matches_the_walk(cuda, geo, dtype, quant, tol):
    args, kw = _inputs(cuda, *geo, dtype=dtype, quant=quant, seed=1)
    before = tpk.paged_attention_kernel.launches
    got = tpk.paged_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert tpk.paged_attention_kernel.launches == before + 1
    want = tpk.paged_attention_reference(*args, **kw)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        float(err.max())


def test_kernel_raises_instead_of_falling_back(cuda):
    """A CUDA call the kernel cannot take raises; nothing falls back to
    the walk and nothing is counted."""
    args, kw = _inputs(cuda, 2, 1, 4, 2, 64, 8, 2, torch.float32, False,
                       seed=2)
    before = tpk.paged_attention_kernel.launches
    with pytest.raises(ValueError, match="q dtype"):
        tpk.paged_attention_kernel(args[0].half(), *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tpk.paged_attention_kernel(args[0], args[1], args[2],
                                   args[3].t().contiguous().t(), args[4],
                                   **kw)
    assert tpk.paged_attention_kernel.launches == before


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_through_the_kernel_matches_the_walk(cuda, kv_quant):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1,
                           use_flash_attention=False)
    model = LlamaForCausalLM(cfg, device="cuda")
    streams, logits = {}, {}
    for impl in ("kernel", "reference"):
        eng = PagedLlamaDecodeEngine(model, max_slots=2, max_seq=128,
                                     block_size=16, prefill_chunk=16,
                                     kv_quant=kv_quant,
                                     attention_impl=impl)
        before = tpk.paged_attention_kernel.launches
        streams[impl] = eng.generate(list(range(1, 40)), 12)
        launched = tpk.paged_attention_kernel.launches - before
        # 3 prefill chunks + 11 decode steps, one launch per layer each
        assert launched == (14 * cfg.num_hidden_layers
                            if impl == "kernel" else 0)
        eng.prefill(0, [5, 6, 7], budget=2)
        logits[impl] = eng.last_logits.float()
    assert streams["kernel"] == streams["reference"]
    torch.testing.assert_close(logits["kernel"], logits["reference"],
                               atol=1e-4, rtol=1e-4)
    srv = GenerationServer(PagedLlamaDecodeEngine(
        model, max_slots=2, max_seq=128, block_size=16, prefill_chunk=16,
        kv_quant=kv_quant))
    try:
        assert srv.generate(list(range(1, 40)), 12, timeout=120) == \
            streams["kernel"]
    finally:
        assert srv.shutdown(timeout=60)


def _flash_inputs(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,causal", [((2, 200, 3, 128), True),
                                          ((2, 77, 2, 64), False),
                                          ((6, 130, 64), True),
                                          ((1, 1, 2, 128), True)],
                         ids=["d128-causal", "d64-full", "bhld-d64",
                              "L1"])
def test_flash_kernels_match_their_plain_versions(cuda, shape, causal,
                                                  dtype, tol):
    q, k, v, do = _flash_inputs(cuda, shape, dtype, seed=len(shape))
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    ref_dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal)
    ref_dk, ref_dv = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal)
    for got, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                     (dk, ref_dk), (dv, ref_dv)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        # the plain versions do the kernels' roundings; near-zero
        # gradients (L = 1: dP - delta cancels) need the absolute part
        err = (got.float() - ref.float()).abs()
        assert bool((err <= tol * (1 + ref.float().abs())).all()), \
            float(err.max())


def _check_all(got, ref, tol):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        err = (g.float() - r.float()).abs()
        assert bool((err <= tol * (1 + r.float().abs())).all()), \
            float(err.max())


def _three(q, k, v, do, causal, **kw):
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, None, **kw)
    delta = tfa.attention_delta(out, do)
    return (out, lse,
            tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                       None, **kw),
            *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         None, **kw)), (lse, delta)


def _three_plain(q, k, v, do, causal, lse, delta, **kw):
    out, lse_r = tfa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                   **kw)
    return (out, lse_r,
            tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                 causal, None, **kw),
            *tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal, None, **kw))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,causal", [((2, 200, 3, 128), True),
                                          ((2, 77, 2, 64), False),
                                          ((6, 130, 64), True)],
                         ids=["d128-causal", "d64-full", "bhld-d64"])
def test_flash_dropout_kernels_match_their_plain_versions(cuda, shape,
                                                          causal, dtype,
                                                          tol):
    """K5: the same seed gives the kernels and the plain versions the
    same keep mask; each launch counts as a dropout launch."""
    q, k, v, do = _flash_inputs(cuda, shape, dtype, seed=11)
    kw = dict(dropout_p=0.1, seed=0xDEADBEEF12345)
    before = [w.dropout_launches for w in (tfa.flash_attention_fwd,
                                           tfa.flash_attention_bwd_dq,
                                           tfa.flash_attention_bwd_dkv)]
    got, (lse, delta) = _three(q, k, v, do, causal, **kw)
    torch.cuda.synchronize()
    assert [w.dropout_launches for w in (tfa.flash_attention_fwd,
                                         tfa.flash_attention_bwd_dq,
                                         tfa.flash_attention_bwd_dkv)] == [
        b + 1 for b in before]
    _check_all(got, _three_plain(q, k, v, do, causal, lse, delta, **kw),
               tol)
    zero, _ = _three(q, k, v, do, causal)
    assert not torch.equal(zero[0], got[0])
    same, _ = _three(q, k, v, do, causal, dropout_p=0.0, seed=3)
    for a, b in zip(zero, same):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_segmented_kernels_match_their_plain_versions(cuda, causal,
                                                            dtype, tol):
    """K4: packed sequences of 1 to 300 tokens (tiles that start inside
    another segment, tiles skipped), and unsorted ids."""
    lengths = [1, 300, 37, 64, 5, 150, 99]
    seg = torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32),
        torch.tensor(lengths))[None].to(cuda)
    shuffled = torch.randint(0, 3, seg.shape, device=cuda,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(1), dtype=torch.int32)
    for s in (seg, shuffled):
        q, k, v, do = _flash_inputs(cuda, (1, seg.shape[1], 4, 64), dtype,
                                    seed=12)
        before = tfa.flash_attention_bwd_dkv.segmented_launches
        got, (lse, delta) = _three(q, k, v, do, causal, seg=s)
        torch.cuda.synchronize()
        assert tfa.flash_attention_bwd_dkv.segmented_launches == before + 1
        _check_all(got, _three_plain(q, k, v, do, causal, lse, delta, seg=s),
                   tol)


def test_flash_dropout_and_segment_arguments_raise(cuda):
    q, k, v, _ = _flash_inputs(cuda, (1, 16, 2, 64), torch.bfloat16, 3)
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="needs a seed"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match="< 1"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=1.0, seed=1)
    with pytest.raises(TypeError, match="seed"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1, seed=1.5)
    with pytest.raises(ValueError, match="seg"):
        tfa.flash_attention_fwd(q, k, v, seg=torch.zeros(
            1, 16, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="seg"):
        tfa.flash_attention_fwd(q, k, v, seg=torch.zeros(
            1, 15, dtype=torch.int32, device=cuda))
    assert tfa.flash_attention_fwd.launches == before


def test_flash_kernels_raise_instead_of_falling_back(cuda):
    q, k, v, _ = _flash_inputs(cuda, (1, 16, 2, 64), torch.float32, 3)
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32])
    strided = [torch.randn(1, 16, 2, 64, 2, device=cuda)[..., 0]
               for _ in range(3)]                 # head-dim stride 2
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(*strided)
    assert tfa.flash_attention_fwd.launches == before


def _flash_layout(dev, layout, dtype):
    """q, k, v, do of one layout: fresh [B, L, H, D] (causal and full, a
    ragged L, L = 1), [BH, L, D], q/k/v as views of one [B, L, 3, H, D]
    projection, heads outside the sequence ([B, H, L, D] transposed), and
    D 64 (which only the first design takes)."""
    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if layout == "strided_qkv":
        q, k, v = rnd(2, 300, 3, 4, 128).unbind(2)
        return q, k, v, rnd(2, 300, 4, 128)
    if layout == "heads_outer":
        q, k, v = (rnd(2, 4, 260, 128).transpose(1, 2) for _ in range(3))
        return q, k, v, rnd(2, 260, 4, 128)
    shape = {"blhd_causal": (2, 384, 3, 128), "blhd_full": (2, 384, 3, 128),
             "ragged": (2, 200, 3, 128), "l1": (2, 1, 3, 128),
             "bhld": (6, 130, 128), "d64": (2, 130, 3, 64)}[layout]
    return tuple(rnd(*shape) for _ in range(4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["blhd_causal", "blhd_full", "ragged",
                                    "l1", "bhld", "strided_qkv",
                                    "heads_outer", "d64"])
def test_flash_wrappers_take_the_design_takes_tma_picks(cuda, layout, dtype,
                                                        tol):
    """Each launch goes to the design takes_tma names (bf16 at D 128: the
    TMA / wgmma kernels; f32 and D 64: the first design), as the counts
    show, and agrees with the plain versions."""
    q, k, v, do = _flash_layout(cuda, layout, dtype)
    causal = layout != "blhd_full"
    tma = dtype == torch.bfloat16 and q.shape[-1] == 128
    assert tfa.takes_tma(q, k, v, do) is tma
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    before = [(w.launches, w.tma_launches) for w in ws]
    got, (lse, delta) = _three(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert [(w.launches, w.tma_launches) for w in ws] == [
        (a + 1, b + tma) for a, b in before]
    _check_all(got, _three_plain(q, k, v, do, causal, lse, delta), tol)


def test_flash_autograd_on_the_tma_kernels_matches_autograd_through_sdpa(
        cuda):
    """FlashAttention at (2, 512, 8, 128) causal, bf16, through the TMA
    kernels, against autograd through sdpa_reference: out and each
    gradient within 2e-2 relative RMS (the sdpa rounds its logits and
    its PV product to bf16)."""
    from paddle_tpu_torch.nn.functional import sdpa_reference
    q, k, v, do = _flash_inputs(cuda, (2, 512, 8, 128), torch.bfloat16, 7)
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    before = [w.tma_launches for w in ws]
    outs = []
    for fn in (lambda a, b, c: tfa.flash_attention(a, b, c, True),
               lambda a, b, c: sdpa_reference(a, b, c, causal=True)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs)
        outs.append([o.detach().float()] + [
            x.float() for x in torch.autograd.grad(o, xs, do)])
    assert [w.tma_launches for w in ws] == [b + 1 for b in before]
    for a, b in zip(*outs):
        rel = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
        assert rel <= 2e-2, rel


def test_flash_tma_entries_refuse_and_the_wrappers_raise(cuda, monkeypatch):
    """The TMA entries re-check what takes_tma decided and return an
    error; a wrapper whose TMA launch is refused raises, counts nothing
    and does not fall back to the first design."""
    q, k, v, do = _flash_inputs(cuda, (1, 64, 2, 128), torch.bfloat16, 5)
    lib = tfa._kernel_lib_tma()
    out = torch.empty_like(q)
    lse = torch.empty(1, 2, 64, dtype=torch.float32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for D in (64, 130):     # head dims these kernels do not take
        assert lib.flash_attention_tma_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), tfa._strides(q, k, v, out), 1, 64, 2, D, 1,
            0.1, stream) != 0
    misaligned = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)[1:]
    assert lib.flash_attention_tma_forward(
        misaligned.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tfa._strides(q, k, v, out), 1, 64, 2, 128, 1, 0.1,
        stream) != 0

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1          # cudaErrorInvalidValue

    monkeypatch.setattr(tfa, "_kernel_lib_tma", lambda: Refusing())
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    before = [(w.launches, w.tma_launches) for w in ws]
    with pytest.raises(RuntimeError, match="TMA"):
        tfa.flash_attention_fwd(q, k, v, True)
    delta = torch.zeros(1, 2, 64, dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="TMA"):
        tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    with pytest.raises(RuntimeError, match="TMA"):
        tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    assert [(w.launches, w.tma_launches) for w in ws] == before


def test_train_step_through_the_kernels_matches_the_plain_sdpa(cuda):
    """One AdamW TrainStep of a tiny f32 Llama with flash attention
    against the same step with the plain sdpa: equal losses up to f32
    summation order; parameters too, except where AdamW's first step
    (about lr * sign(g)) meets a gradient near zero: all within 2 lr,
    99.9 % within 1e-5."""
    ids = torch.randint(0, 128, (2, 48), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    losses, params = [], []
    for flash in (True, False):
        cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                               num_key_value_heads=1,
                               use_flash_attention=flash)
        model = LlamaForCausalLM(cfg, device="cuda")
        step = TrainStep(model, LlamaPretrainingCriterion(),
                         AdamW(learning_rate=1e-3,
                               parameters=model.named_parameters()))
        before = tfa.flash_attention_fwd.launches
        losses.append(step(ids, ids))
        assert tfa.flash_attention_fwd.launches - before == (
            cfg.num_hidden_layers if flash else 0)
        params.append([p.detach().clone() for p in model.parameters()])
    torch.testing.assert_close(losses[0], losses[1], atol=1e-5, rtol=1e-5)
    err = torch.cat([(a - b).abs().flatten() for a, b in zip(*params)])
    assert float(err.max()) <= 2e-3
    assert float((err <= 1e-5).float().mean()) >= 0.999


# -- grouped matmul (K6, K7) -------------------------------------------------

# 16 groups of 0-60 rows from a numpy seed: tiles straddle several
_SMALL = [int(x) for x in np.random.default_rng(3).integers(0, 61, 16)]
GMM_LAYOUTS = {
    # name: (T, K, N, group sizes or None, tile ids or None, block_t);
    # E is the number of sizes, else 4
    "aligned": (512, 256, 384, [128, 128, 128, 128], None, 128),
    "ragged_empty_padding": (640, 128, 256, [128, 0, 256, 128], None, 128),
    "unaligned": (300, 200, 72, [37, 0, 101, 150], None, 128),
    "tile_ids": (512, 128, 128, None, [0, 0, 2, 3], 128),
    "odd_k_n": (100, 37, 45, [10, 60, 0, 20], None, 128),
    "many_small_groups": (sum(_SMALL) + 24, 64, 136, _SMALL, None, 128),
    "mid_box_ranges": (400, 64, 128, [70, 130, 1, 63, 65, 0], None, 128),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(GMM_LAYOUTS))
def test_grouped_matmul_kernels_match_their_plain_versions(cuda, name,
                                                           dtype, tol):
    t, k, n, sizes, ids, bt = GMM_LAYOUTS[name]
    e = 4 if sizes is None else len(sizes)
    g_ = torch.Generator(device=cuda).manual_seed(len(name))
    lhs, g = (torch.randn(s, generator=g_, device=cuda).to(dtype)
              for s in ((t, k), (t, n)))
    rhs = torch.randn((e, k, n), generator=g_, device=cuda).to(dtype)
    if ids is None:
        off = tgmm.offsets_from_group_sizes(sizes, e, t, cuda)
    else:
        off = tgmm.offsets_from_tile_ids(ids, e, bt, t, cuda)
    ws = (tgmm.grouped_matmul_fwd, tgmm.grouped_matmul_dlhs,
          tgmm.grouped_matmul_drhs)
    before = [(w.launches, w.tma_launches) for w in ws]
    got = (tgmm.grouped_matmul_fwd(lhs, rhs, off),
           tgmm.grouped_matmul_dlhs(g, rhs, off),
           tgmm.grouped_matmul_drhs(lhs, g, off, e))
    torch.cuda.synchronize()
    # bf16 with 16-byte rows takes the TMA / wgmma kernels, the rest the
    # general ones
    tma = int(dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0)
    assert [(w.launches, w.tma_launches) for w in ws] == [
        (a + 1, b + tma) for a, b in before]
    want = (tgmm.grouped_matmul_fwd_reference(lhs, rhs, off),
            tgmm.grouped_matmul_fwd_reference(g, rhs.transpose(1, 2), off),
            tgmm.grouped_matmul_drhs_reference(lhs, g, off, e))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = (a.float() - b.float()).abs()
        assert bool((err <= tol * (1 + b.float().abs())).all()), \
            float(err.max())
    if sizes is not None and 0 in sizes:
        assert not got[2][sizes.index(0)].any()      # exact zeros


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_grouped_matmul_autograd_matches_the_dense_oracle(cuda, dtype, tol):
    """One forward + backward through the entry launches K6 twice and K7
    once and agrees (relative RMS) with autograd through the oracle."""
    t, k, n, sizes = 300, 200, 72, [37, 0, 101, 150]
    g_ = torch.Generator(device=cuda).manual_seed(5)
    lhs = torch.randn((t, k), generator=g_, device=cuda).to(dtype)
    rhs = torch.randn((4, k, n), generator=g_, device=cuda).to(dtype)
    dy = torch.randn((t, n), generator=g_, device=cuda).to(dtype)
    outs = []
    for fn in (tgmm.grouped_matmul, tgmm.grouped_matmul_reference):
        xs = [x.clone().requires_grad_() for x in (lhs, rhs)]
        before = (tgmm.grouped_matmul_fwd.launches
                  + tgmm.grouped_matmul_dlhs.launches,
                  tgmm.grouped_matmul_drhs.launches,
                  tgmm.grouped_matmul_fwd.tma_launches
                  + tgmm.grouped_matmul_dlhs.tma_launches
                  + tgmm.grouped_matmul_drhs.tma_launches)
        y = fn(*xs, torch.tensor(sizes, device=cuda))
        outs.append([y.detach()] + list(torch.autograd.grad(y, xs, dy)))
        after = (tgmm.grouped_matmul_fwd.launches
                 + tgmm.grouped_matmul_dlhs.launches,
                 tgmm.grouped_matmul_drhs.launches,
                 tgmm.grouped_matmul_fwd.tma_launches
                 + tgmm.grouped_matmul_dlhs.tma_launches
                 + tgmm.grouped_matmul_drhs.tma_launches)
        # K 200, N 72: bf16 through the TMA kernels, f32 the general ones
        tma = 3 if dtype == torch.bfloat16 else 0
        assert [a - b for a, b in zip(after, before)] == (
            [2, 1, tma] if fn is tgmm.grouped_matmul else [0, 0, 0])
    for a, b in zip(*outs):
        rel = (a.float() - b.float()).square().mean().sqrt() / \
            b.float().square().mean().sqrt()
        assert float(rel) <= tol


def test_grouped_matmul_kernels_raise_instead_of_falling_back(cuda):
    lhs = torch.randn(64, 32, device=cuda)
    rhs = torch.randn(2, 32, 16, device=cuda)
    off = tgmm.offsets_from_group_sizes([32, 32], 2, 64, cuda)
    before = tgmm.grouped_matmul_fwd.launches
    with pytest.raises(ValueError, match="dtype"):
        tgmm.grouped_matmul_fwd(lhs.half(), rhs.half(), off)
    with pytest.raises(ValueError, match="offsets"):
        tgmm.grouped_matmul_fwd(lhs, rhs, off.long())
    with pytest.raises(ValueError, match="contiguous"):
        tgmm.grouped_matmul_fwd(lhs.t().contiguous().t(), rhs, off)
    with pytest.raises(ValueError, match="strides"):
        tgmm.grouped_matmul_fwd(
            lhs, torch.randn(2, 32, 16, 2, device=cuda)[..., 0], off)
    assert tgmm.grouped_matmul_fwd.launches == before


def test_ernie_moe_step_through_the_kernels_matches_the_plain_sdpa(cuda):
    """One forward + backward of a small f32 ERNIE-MoE (head dim 64)
    through the flash kernels against the same with the plain sdpa:
    equal routing, losses and gradients (relative RMS) up to f32
    summation order."""
    ids = torch.randint(0, 128, (2, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    runs = []
    for flash in (True, False):
        cfg = ErnieMoEConfig.tiny(hidden_size=256, intermediate_size=512,
                                  use_flash_attention=flash)
        model = ErnieMoEForCausalLM(cfg, device="cuda")
        before = tfa.flash_attention_fwd.launches
        loss = LlamaPretrainingCriterion()(model(ids), ids) + \
            model.total_aux_loss()
        loss.backward()
        assert tfa.flash_attention_fwd.launches - before == (
            cfg.num_hidden_layers if flash else 0)
        runs.append((loss.detach(), [p.grad for p in model.parameters()],
                     model.moe_layers()[0].drop_share))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=1e-5, rtol=1e-5)
    assert torch.equal(runs[0][2], runs[1][2])
    for a, b in zip(runs[0][1], runs[1][1]):
        rel = (a - b).square().mean().sqrt() / \
            b.square().mean().sqrt().clamp(min=1e-30)
        assert float(rel) <= 1e-4

"""Tests of the port that need the card: the Hopper paged-attention
kernels against their plain walks (the split design for bf16 calls, by
its counts; its entry's refusals, its tickets; the speculative verify
window on the tensor cores), a tiny engine through the kernel against
the same engine through the walk, a speculative server's stream against
plain stepping and a weight swap on the card, the three flash-attention kernels
against their plain versions (plain, with dropout and with segments;
bf16 at head dim 64 or 128 on the TMA / wgmma kernels, with dropout at
head dim 64 and with segments without dropout, everything else on the
first design, by their counts; the D-64 keep mask bit for bit),
a tiny Llama train step through them against the same step through
the plain sdpa, the grouped-matmul kernels (K6 forward and dlhs, K7
drhs; TMA / wgmma for bf16 with 16-byte rows, the general kernels
otherwise, by their counts) against their plain versions and the op's
autograd against the dense oracle's, a tiny ERNIE-MoE step, and the
high-level trainer on whole-step CUDA graphs (``Model`` through
``CapturedStep``: captured against eager bit for bit, an lr change
between replays, a new shape and LRU eviction, lazy losses not
aliased, a GradScaler inf step skipped, a dropout model captured), and
``jit.TrainStep`` on the same engine with the dropout keys drawn on the
card (a tiny BERT with dropout captured against its eager loop, fresh
masks every replay, a reseed between replays restarting the stream
without a new capture), and the vision slice (conv, pooling and batch
norm on the card against the same calls on the CPU, batch norm with no
host read, a tiny NHWC ResNet through ``TrainStep`` with Momentum:
replays against its eager loop), and dy2static and the inference
artifact (the ``flash_fwd`` operator against the wrapper, an exported
tiny GPT through K1a/K1b, ``to_static`` replaying CUDA graphs with one
guard fetch, ``full_graph=True`` as one graph), and the serving step as
CUDA graphs (K3's operator reading its tile count inside a graph,
``_int_mm``'s row padding, ``capture_jit`` replays and re-captures, the
captured engines against the same engines op by op, bf16 and int8, and
the exported decode step on the card), and the rest of
``paddle.vision`` (a MobileNetV2 ``TrainStep`` with its dropout in the
graph against its eager loop, ``deform_conv2d`` and ``grid_sample``
against the CPU). Each skips (with its reason)
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


def _key(dev, seed):
    """A 64-bit seed as the key tensor the flash wrappers take (int64
    [2] on the card, its low and high words)."""
    return torch.tensor([seed & 0xFFFFFFFF, seed >> 32], dtype=torch.int64,
                        device=dev)


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


@pytest.mark.parametrize("geo,quant", [
    ((3, 1, 8, 8, 128, 16, 40), False),
    ((3, 2, 8, 8, 64, 16, 40), True),
    ((2, 1, 32, 8, 128, 16, 64), False),
    ((1, 64, 8, 8, 128, 16, 80), True),
    ((1, 40, 4, 1, 64, 32, 20), False),
    ((1, 96, 4, 4, 128, 128, 8), False),
    ((4, 5, 8, 8, 128, 16, 40), False)],
    ids=["mha-decode", "int8-verify-t2-d64", "gqa4-decode",
         "int8-prefill-chunk", "mqa-chunk-d64-bs32", "dense-bs128-t96",
         "mha-spec-verify-t5"])
def test_split_design_takes_bf16_calls_and_matches_its_plain_versions(
        cuda, geo, quant):
    """bf16 calls take the split design (CUDA-core groups of 1 and 4 rows,
    tensor-core groups of 64, as split_plan names them), as the counts
    show, and agree with the
    walk in bf16 (2e-2 abs + rel) and, within one bf16 rounding of the
    output (1e-5 + 2^-8 rel), with the split walk on f32 copies of the
    same inputs, spanned as the kernel spans them."""
    args, kw = _inputs(cuda, *geo, dtype=torch.bfloat16, quant=quant, seed=3)
    q, kp, vp, tables, pos = args
    assert tpk.takes_split(q, kp, tables)
    S, T, H, D = q.shape
    g, _, span, _ = tpk.split_plan(T, kw["n_rep"], S, kp.shape[2], D,
                                   kp.shape[1], tables.shape[1],
                                   tpk._sms(q.device))
    w = tpk.paged_attention_kernel
    before = (w.launches, w.split_launches, w.mma_launches)
    got = w(*args, **kw).float()
    torch.cuda.synchronize()
    assert (w.launches, w.split_launches, w.mma_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(g == 64))
    want = tpk.paged_attention_reference(*args, **kw).float()
    assert bool(((got - want).abs() <= 2e-2 * (1 + want.abs())).all())
    if kp.dtype != torch.int8:
        kp, vp = kp.float(), vp.float()
    ref32 = tpk.paged_attention_split_reference(q.float(), kp, vp, tables,
                                                pos, span=span, **kw)
    err = (got - ref32).abs()
    assert bool((err <= 1e-5 + 2.0 ** -8 * ref32.abs()).all()), \
        float(err.max())


def test_split_design_leaves_its_tickets_at_zero_and_repeats_itself(cuda):
    """A long history over many spans: the last CTA of each unit resets
    its ticket (the buffer is all zeros after the launch), and the merge
    adds the spans in a fixed order, so a second launch gives the same
    bits."""
    args, kw = _inputs(cuda, 2, 1, 16, 4, 128, 16, 256, torch.bfloat16,
                       False, seed=6)
    first = tpk.paged_attention_kernel(*args, **kw)
    second = tpk.paged_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    tickets = tpk._ticket_bufs[(first.device.index, stream)]
    assert int(tickets.abs().sum()) == 0


def test_split_entry_refuses_and_the_wrapper_raises(cuda, monkeypatch):
    """The split entry re-checks what takes_split and split_plan decided
    and returns an error for what its kernels do not take; a wrapper
    whose split launch is refused raises, counts nothing and does not
    fall back to the first design."""
    args, kw = _inputs(cuda, 2, 1, 4, 4, 128, 16, 8, torch.bfloat16, False,
                       seed=4)
    q, kp, vp, tables, pos = args
    out = torch.empty_like(q)
    nt = torch.tensor([8], dtype=torch.int32, device=cuda)
    lib = tpk._kernel_lib_split()
    stream = torch.cuda.current_stream().cuda_stream

    def call(group_rows=1, span=256, D=128, kv=1, q_ptr=None):
        # 128 columns in one span: no scratch is needed
        return lib.paged_attention_split_forward(
            q_ptr or q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
            tables.data_ptr(), pos.data_ptr(), nt.data_ptr(), out.data_ptr(),
            None, None, None, 2, 1, 4, 4, D, 16, 8, kp.shape[0], kv,
            group_rows, span, stream)

    assert call() == 0
    for bad in (dict(group_rows=8), dict(span=48), dict(span=4096),
                dict(D=96), dict(kv=0), dict(q_ptr=q.data_ptr() + 2)):
        assert call(**bad) != 0, bad

    class Refusing:
        def __getattr__(self, name):
            return lambda *a: 1          # cudaErrorInvalidValue

    monkeypatch.setattr(tpk, "_kernel_lib_split", lambda: Refusing())
    w = tpk.paged_attention_kernel
    before = (w.launches, w.split_launches, w.mma_launches)
    with pytest.raises(RuntimeError, match="split"):
        w(*args, **kw)
    assert (w.launches, w.split_launches, w.mma_launches) == before


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


def _tiny_llama_on_card():
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, use_flash_attention=False)
    return LlamaForCausalLM(cfg, device="cuda")


_SPEC_GEO = dict(max_slots=2, max_seq=128, block_size=16, prefill_chunk=16)


def test_speculative_stream_on_the_card_equals_plain_stepping(cuda):
    """A 2-layer target with make_draft()'s 1-layer view through a
    speculative server: the stream equals plain stepping's (f32, the
    kernel on both paths), spec steps ran, one K3 launch a layer for each
    verify and k a draft layer for each proposal window, and both pools
    drain with their invariants holding."""
    from paddle_tpu_torch.observability import metrics as om
    model = _tiny_llama_on_card()
    prompt = list(range(1, 40))
    want = PagedLlamaDecodeEngine(model, **_SPEC_GEO).generate(prompt, 24)
    eng = PagedLlamaDecodeEngine(model, **_SPEC_GEO)
    eng.attach_draft(eng.make_draft(), spec_tokens=4)
    steps = om.default_registry().get("serving.spec_steps_total")
    before = steps.value()
    srv = GenerationServer(eng)
    try:
        got = srv.generate(prompt, 24, timeout=120)
    finally:
        assert srv.shutdown(timeout=60)
    assert got == want
    assert steps.value() > before
    for kv in (eng._kv, eng._draft._kv):
        kv.check_invariants()
        assert kv.stats()["blocks_used"] == 0


def test_weight_swap_on_the_card(cuda):
    """Swapping to a clone of the same weights mid-stream leaves the
    stream as it was; a prepared tree with one leaf on the CPU is
    refused on its device with the old weights kept."""
    model = _tiny_llama_on_card()
    prompt = list(range(3, 30))
    want = PagedLlamaDecodeEngine(model, **_SPEC_GEO).generate(prompt, 16)
    eng = PagedLlamaDecodeEngine(model, **_SPEC_GEO)
    out = [eng.prefill(0, prompt, budget=16)]
    out += [int(eng.step()[0]) for _ in range(5)]
    eng.swap_weights({k: v.clone() for k, v in model.state_dict().items()})
    out += [int(eng.step()[0]) for _ in range(10)]
    assert out == want
    old = eng.params
    tree = eng.prepare_swap(model.state_dict())
    tree["layers"][0]["q_proj"] = tree["layers"][0]["q_proj"].cpu()
    with pytest.raises(ValueError, match="layers.0.q_proj"):
        eng.swap_weights(prepared=tree)
    assert eng.params is old
    eng.release(0)


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
    kw = dict(dropout_p=0.1, seed=_key(cuda, 0xDEADBEEF12345))
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


_FLASH_WRAPPERS = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                   tfa.flash_attention_bwd_dkv)


def _seg_counts():
    return [(w.segmented_launches, w.tma_launches) for w in _FLASH_WRAPPERS]


def _packed(dev, lengths):
    return torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32),
        torch.tensor(lengths))[None].to(dev)


@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_segmented_kernels_match_their_plain_versions(cuda, causal,
                                                            dtype, tol, d):
    """K4: packed sequences of 1 to 300 tokens (tiles that start inside
    another segment, tiles skipped), and unsorted ids; bf16 on the TMA
    kernels (their windows a superset for the unsorted ids), f32 on the
    first design, by the counts."""
    seg = _packed(cuda, [1, 300, 37, 64, 5, 150, 99])
    shuffled = torch.randint(0, 3, seg.shape, device=cuda,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(1), dtype=torch.int32)
    tma = int(dtype == torch.bfloat16)
    for s in (seg, shuffled):
        q, k, v, do = _flash_inputs(cuda, (1, seg.shape[1], 4, d), dtype,
                                    seed=12)
        before = _seg_counts()
        got, (lse, delta) = _three(q, k, v, do, causal, seg=s)
        torch.cuda.synchronize()
        assert _seg_counts() == [(a + 1, b + tma) for a, b in before]
        _check_all(got, _three_plain(q, k, v, do, causal, lse, delta, seg=s),
                   tol)


@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_segmented_tma_masks_whole_tiles_of_another_segment(cuda,
                                                                  causal, d):
    """K4 on the TMA kernels where rows meet whole tiles of another
    segment before their own keys: the block of rows 128-255 starts
    inside the first sequence (rows 0-159), so the rows of the second
    sequence in it see the first sequence's key tiles (and, as keys of
    a dK/dV block, its query stages) in their window before their own:
    those pairs must come out as exact zeros, not 2^0 = 1. Two batch
    rows, B 2, the second with the boundary one tile later."""
    seg = torch.cat([_packed(cuda, [160, 300, 52]),
                     _packed(cuda, [224, 236, 52])])
    q, k, v, do = _flash_inputs(cuda, (2, seg.shape[1], 3, d),
                                torch.bfloat16, seed=13)
    before = _seg_counts()
    got, (lse, delta) = _three(q, k, v, do, causal, seg=seg)
    torch.cuda.synchronize()
    assert _seg_counts() == [(a + 1, b + 1) for a, b in before]
    _check_all(got, _three_plain(q, k, v, do, causal, lse, delta, seg=seg),
               2e-2)
    assert bool(torch.isfinite(got[1]).all())


def test_flash_tma_tiles_size_the_windows(cuda):
    """The TMA library reports the tiles each kernel walks, and a plan's
    window table has one entry for each CTA of that kernel's grid: blocks
    of 64 or 128 rows over tiles of 32 to 128, the sizes at which
    tests/test_torch_flash_tma.py holds the windows against a pair
    scan."""
    seg = _packed(cuda, [100, 200, 77])
    plan = tfa.SegmentPlan(seg)
    for d in (64, 128):
        for kernel in ("fwd", "dq", "dkv"):
            block, tile = tfa._tma_tiles(kernel, d)
            assert block in (64, 128) and tile in (32, 64, 128)
            win = plan.window(kernel, d, True)
            assert tuple(win.shape) == (1, -(-seg.shape[1] // block), 2)
    with pytest.raises(ValueError):
        tfa._tma_tiles("fwd", 96)


def test_flash_dropout_and_segment_arguments_raise(cuda):
    q, k, v, _ = _flash_inputs(cuda, (1, 16, 2, 64), torch.bfloat16, 3)
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="needs a seed"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match="< 1"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=1.0, seed=1)
    with pytest.raises(TypeError, match="seed"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1, seed=1.5)
    # the kernels read a key tensor on the inputs' device, not an int
    with pytest.raises(TypeError, match="key"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1, seed=1)
    with pytest.raises(ValueError, match="lies on cpu"):
        tfa.flash_attention_fwd(q, k, v, dropout_p=0.1,
                                seed=torch.tensor([1, 2]))
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
    D 64."""
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
    """Each launch goes to the design takes_tma names (bf16 at D 64 and
    128: the TMA / wgmma kernels; f32: the first design), as the counts
    show, and agrees with the plain versions."""
    q, k, v, do = _flash_layout(cuda, layout, dtype)
    causal = layout != "blhd_full"
    tma = dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
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


def _cross_inputs(dev, B, Lq, Lk, H, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, L, H, D), generator=g, device=dev).to(dtype)
            for L in (Lq, Lk, Lk, Lq)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geo", [(3, 96, 128, 4, 64, False, 0.0),
                                 (3, 96, 128, 4, 64, False, 0.1),
                                 (4, 1, 200, 2, 128, True, 0.0),
                                 (2, 300, 200, 2, 64, True, 0.0),
                                 (2, 130, 70, 2, 128, True, 0.0),
                                 (1, 77, 300, 3, 128, False, 0.0)],
                         ids=["cross", "cross-dropout", "cache-step",
                              "more-queries-causal", "more-queries-d128",
                              "history"])
def test_flash_kernels_at_unequal_lengths_match_their_plain_versions(
        cuda, geo, dtype, tol):
    """Lq != Lk through the design takes_tma picks (bf16: the TMA kernels,
    f32: the first design), one launch each, against the plain versions
    (the backward kernels on the plain forward's lse and delta)."""
    B, Lq, Lk, H, D, causal, p = geo
    q, k, v, do = _cross_inputs(cuda, B, Lq, Lk, H, D, dtype, 3)
    kw = {"dropout_p": p, "seed": _key(cuda, 0x300000007)} if p else {}
    out, lse = tfa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                 **kw)
    delta = tfa.attention_delta(out, do)
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    before = [(w.launches, w.tma_launches) for w in ws]
    got = (*tfa.flash_attention_fwd(q, k, v, causal, None, **kw),
           tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                      None, **kw),
           *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        None, **kw))
    torch.cuda.synchronize()
    tma = int(tfa.takes_tma(q, k, v, do, dropout_p=p))
    assert tma == int(dtype == torch.bfloat16 and (not p or D == 64))
    assert [(w.launches - a, w.tma_launches - b)
            for w, (a, b) in zip(ws, before)] == [(1, tma)] * 3
    ref = (out, lse,
           tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, None, **kw),
           *tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  causal, None, **kw))
    _check_all(got, ref, tol)


@pytest.mark.parametrize("Lq,Lk,causal", [(96, 128, False),
                                          (300, 200, True), (1, 50, True)])
def test_flash_autograd_at_unequal_lengths_matches_the_sdpa(cuda, Lq, Lk,
                                                           causal):
    """FlashAttention (the rows with no allowed key filled with V's mean)
    against autograd through sdpa_reference, f32 on the first design:
    out and each gradient within 1e-5 relative RMS."""
    from paddle_tpu_torch.nn.functional import sdpa_reference
    q, k, v, do = _cross_inputs(cuda, 2, Lq, Lk, 2, 64, torch.float32, 9)
    outs = []
    for fn in (lambda a, b, c: tfa.flash_attention(a, b, c, causal),
               lambda a, b, c: sdpa_reference(a, b, c, causal=causal)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs)
        outs.append([o.detach()] + list(torch.autograd.grad(o, xs, do)))
    for a, b in zip(*outs):
        rel = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
        assert rel <= 1e-5, rel


def test_flash_tma_entries_refuse_and_the_wrappers_raise(cuda, monkeypatch):
    """The TMA entries re-check what takes_tma decided and return an
    error; a wrapper whose TMA launch is refused raises, counts nothing
    and does not fall back to the first design."""
    q, k, v, do = _flash_inputs(cuda, (1, 64, 2, 128), torch.bfloat16, 5)
    lib = tfa._kernel_lib_tma()
    out = torch.empty_like(q)
    lse = torch.empty(1, 2, 64, dtype=torch.float32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    no_seg = (None, 0, None, None)
    key = _key(cuda, 0x200000001)
    no_drop = (None, 0, 1.0)
    drop = (key.data_ptr(), tfa.dropout_threshold(0.1), 1 / 0.9)
    for D in (32, 96, 130):     # head dims these kernels do not take
        assert lib.flash_attention_tma_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), tfa._strides(q, k, v, out), 1, 64, 64, 2, D,
            1, 0.1, *no_seg, *no_drop, stream) != 0
    # dropout (thresh != 0) at D 128
    assert lib.flash_attention_tma_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tfa._strides(q, k, v, out), 1, 64, 64, 2, 128, 1,
        0.1,
        *no_seg, *drop, stream) != 0
    misaligned = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)[1:]
    assert lib.flash_attention_tma_forward(
        misaligned.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tfa._strides(q, k, v, out), 1, 64, 64, 2, 128, 1,
        0.1,
        *no_seg, *no_drop, stream) != 0
    # segments with dropout (no instance), and ids without their windows
    plan = tfa.SegmentPlan(torch.zeros(1, 64, dtype=torch.int32,
                                       device=cuda))
    win = plan.window("fwd", 64, True)
    q64, k64, v64 = (x[..., :64].contiguous() for x in (q, k, v))
    o64 = torch.empty_like(q64)
    segs = (plan.ids.data_ptr(), 64, plan.ranges.data_ptr(), win.data_ptr())
    # ... and dropout without its key (the kernels read it from memory)
    for seg, dr in ((segs, drop), (segs[:3] + (None,), no_drop),
                    (no_seg, (None,) + drop[1:])):
        assert lib.flash_attention_tma_forward(
            q64.data_ptr(), k64.data_ptr(), v64.data_ptr(), o64.data_ptr(),
            lse.data_ptr(), tfa._strides(q64, k64, v64, o64), 1, 64, 64, 2,
            64, 1, 0.125, *seg, *dr, stream) != 0

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


def _d64_layout(dev, layout, dtype=torch.bfloat16):
    """q, k, v, do at head dim 64: [B, L, H, D], [BH, L, D], a ragged
    L 1000, L = 1, BERT's q, k, v (three projections viewed as
    [B, L, 12, 64]) and ERNIE-MoE's (one [B, L, 3 x 768] projection split
    into views of row stride 2304)."""
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if layout == "bert_views":
        q, k, v = (rnd(2, 200, 768).view(2, 200, 12, 64) for _ in range(3))
        return q, k, v, rnd(2, 200, 12, 64)
    if layout == "gpt_views":
        q, k, v = (x.view(2, 300, 12, 64)
                   for x in rnd(2, 300, 3 * 768).split(768, dim=-1))
        return q, k, v, rnd(2, 300, 12, 64)
    shape = {"blhd": (2, 384, 3, 64), "bhld": (6, 130, 64),
             "ragged_l1000": (2, 1000, 2, 64), "l1": (2, 1, 3, 64)}[layout]
    return tuple(rnd(*shape) for _ in range(4))


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["blhd", "bhld", "ragged_l1000", "l1",
                                    "bert_views", "gpt_views"])
def test_flash_d64_tma_kernels_match_their_plain_versions(cuda, layout,
                                                          causal, dropout_p):
    """bf16 at head dim 64 takes the TMA / wgmma kernels, with dropout and
    without (each call's design and dropout by the counts), and agrees
    with the plain versions under the same keep mask."""
    q, k, v, do = _d64_layout(cuda, layout)
    kw = dict(dropout_p=dropout_p, seed=_key(cuda, 0x5EED0123)) \
        if dropout_p else {}
    assert tfa.takes_tma(q, k, v, do, dropout_p=dropout_p) is True
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    counts = ("launches", "tma_launches", "dropout_launches")
    before = [[getattr(w, c) for c in counts] for w in ws]
    got, (lse, delta) = _three(q, k, v, do, causal, **kw)
    torch.cuda.synchronize()
    assert [[getattr(w, c) for c in counts] for w in ws] == [
        [a + 1, b + 1, c + bool(dropout_p)] for a, b, c in before]
    _check_all(got, _three_plain(q, k, v, do, causal, lse, delta, **kw),
               2e-2)


def test_flash_d64_tma_keep_mask_is_exact(cuda):
    """L = 64 = D, q = k = 0 (uniform P) and v = I: out·L·(1 − p) is the
    forward's keep mask; with dO = I, dVᵀ·L·(1 − p) is the backward's.
    Both equal flash_dropout_keep_mask bit for bit, on the TMA kernels;
    p = 0 is the launch without dropout, bit for bit."""
    B, L, H, p = 2, 64, 3, 0.1
    seed = _key(cuda, 0x5EED0123456789AB)
    zeros = torch.zeros((B, L, H, 64), dtype=torch.bfloat16, device=cuda)
    eye = torch.eye(L, device=cuda, dtype=torch.bfloat16)
    ident = eye[None, :, None, :].expand(B, L, H, L).contiguous()
    keep = tfa.flash_dropout_keep_mask(seed, B, H, L, p, cuda)  # [B,H,L,L]
    before = tfa.flash_attention_bwd_dkv.tma_launches
    out, lse = tfa.flash_attention_fwd(zeros, zeros, ident, False, None, p,
                                       seed)
    delta = tfa.attention_delta(out, ident)
    _, dv = tfa.flash_attention_bwd_dkv(zeros, zeros, ident, ident, lse,
                                        delta, False, None, p, seed)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dkv.tma_launches == before + 1
    fwd_mask = (out.float() * L * (1 - p)).round().permute(0, 2, 1, 3)
    bwd_mask = (dv.float() * L * (1 - p)).round().permute(0, 2, 3, 1)
    assert torch.equal(fwd_mask, keep.float())
    assert torch.equal(bwd_mask, keep.float())
    plain = tfa.flash_attention_fwd(zeros, zeros, ident)
    zero_p = tfa.flash_attention_fwd(zeros, zeros, ident, False, None, 0.0,
                                     seed)
    assert all(torch.equal(a, b) for a, b in zip(plain, zero_p))


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


# -- the fused optimizer step (O1, O2) ---------------------------------------

def _opt_table(dev, shapes, dtype, mdtype, seed, gscale=1.0):
    """Parameters, gradients, moments mid-run and beta powers; the last
    entry a view one element into its buffers (not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(n, dt, scale, positive=False):
        x = (torch.rand if positive else torch.randn)(
            n + 1, generator=g, device=dev) * scale
        return x.to(dt)[1:] if n == 1001 else x.to(dt)[:n]

    cols = {k: [] for k in ("p", "g", "m1", "m2", "b1", "b2")}
    for n in shapes:
        cols["p"].append(make(n, dtype, 1.0))
        cols["g"].append(make(n, dtype, gscale))
        cols["m1"].append(make(n, mdtype, 0.1))
        cols["m2"].append(make(n, mdtype, 0.01, True))
        cols["b1"].append(torch.full((), 0.9 ** 3, device=dev))
        cols["b2"].append(torch.full((), 0.999 ** 3, device=dev))
    return cols


def _copy(cols):
    out = {}
    for k, ts in cols.items():
        out[k] = []
        for t in ts:
            c = torch.empty(t.numel() + t.storage_offset(), dtype=t.dtype,
                            device=t.device)[t.storage_offset():]
            out[k].append(c.view(t.shape).copy_(t))
    return out


OPT_SHAPES = [70001, 1, 37, 4096, 1001]


@pytest.mark.parametrize("dtype,f32m", [(torch.bfloat16, False),
                                        (torch.bfloat16, True),
                                        (torch.float32, True),
                                        (torch.float16, False),
                                        (torch.float16, True)],
                         ids=["bf16", "bf16-f32m", "f32", "f16", "f16-f32m"])
@pytest.mark.parametrize("clip,mode", [((), "plain"),
                                       (("global_norm", 1.0), "scaled"),
                                       (("norm", 0.5), "plain"),
                                       (("value", -0.3, 0.3), "found")],
                         ids=["plain", "global-scaled", "norm", "value-found"])
def test_optimizer_kernels_match_their_plain_versions(cuda, dtype, f32m,
                                                      clip, mode):
    """O2 bit-equal to its plain version given O1's scale and flag; O1's
    norms and scale within 1e-6 of its plain version's (summation
    order), its unscaled gradients bit-equal."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    scaled = mode == "scaled"
    ks = _opt_table(cuda, OPT_SHAPES, dtype,
                    torch.float32 if f32m else dtype, 7,
                    1024.0 if scaled else 1.0)
    ps = _copy(ks)
    lr = torch.full((), 1e-3, device=cuda)
    inv = torch.full((), 1 / 1024.0, device=cuda) if scaled else None
    flags = [torch.zeros((), dtype=torch.bool, device=cuda)] \
        if mode == "found" else []
    before = (mt.multi_tensor_unscale_norm.launches,
              mt.multi_tensor_adam.launches)
    scale = None
    o1 = scaled or clip[0] in ("global_norm", "norm") if clip else scaled
    if o1:
        rk = mt.multi_tensor_unscale_norm(ks["g"], inv, clip)
        rr = mt.multi_tensor_unscale_norm_reference(ps["g"], inv, clip)
        torch.testing.assert_close(rk.stats, rr.stats, rtol=1e-6, atol=0)
        if rk.scale is not None:
            torch.testing.assert_close(rk.scale, rr.scale, rtol=1e-6, atol=0)
        for a, b in zip(ks["g"], ps["g"]):
            assert torch.equal(a, b)
        if scaled:
            assert not rk.found and not rr.found
            flags = [rk.found]
        scale = rk.scale
    kw = dict(lr=lr, beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True,
              clip=clip, scale=scale, found=flags)
    wds = [0.0, 0.01, 0.01, 0.0, 0.01]
    mt.multi_tensor_adam(ks["p"], ks["g"], ks["m1"], ks["m2"], ks["b1"],
                         ks["b2"], wds, **kw)
    mt.multi_tensor_adam_reference(ps["p"], ps["g"], ps["m1"], ps["m2"],
                                   ps["b1"], ps["b2"], wds, **kw)
    for k in ("p", "m1", "m2", "b1", "b2"):
        for a, b in zip(ks[k], ps[k]):
            assert torch.equal(a, b), k
    assert (mt.multi_tensor_unscale_norm.launches - before[0],
            mt.multi_tensor_adam.launches - before[1]) == (2 * o1, 1)


def test_optimizer_kernels_skip_a_non_finite_step(cuda):
    """An inf in one gradient: O1 finds it and O2 writes nothing; more
    tensors than one launch takes: O1 and O2 launch twice."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    _, most = mt.config()
    ks = _opt_table(cuda, [3 + i for i in range(most + 5)], torch.bfloat16,
                    torch.float32, 8)
    ks["g"][most + 2][1] = float("inf")
    before = _copy(ks)
    n1, n2 = mt.multi_tensor_unscale_norm.launches, \
        mt.multi_tensor_adam.launches
    res = mt.multi_tensor_unscale_norm(ks["g"], torch.ones((), device=cuda),
                                       ("global_norm", 1.0))
    assert bool(res.found)
    mt.multi_tensor_adam(ks["p"], ks["g"], ks["m1"], ks["m2"], ks["b1"],
                         ks["b2"], [0.01] * len(ks["p"]),
                         lr=torch.full((), 1e-3, device=cuda), beta1=0.9,
                         beta2=0.999, epsilon=1e-8, decoupled=True,
                         clip=("global_norm", 1.0), scale=res.scale,
                         found=[res.found])
    for k in ("p", "m1", "m2", "b1", "b2"):
        for a, b in zip(ks[k], before[k]):
            assert torch.equal(a, b), k
    assert (mt.multi_tensor_unscale_norm.launches - n1,
            mt.multi_tensor_adam.launches - n2) == (3, 2)


def test_optimizer_kernels_raise_instead_of_falling_back(cuda):
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    ks = _opt_table(cuda, [5, 7], torch.float32, torch.float32, 9)
    lr = torch.full((), 1e-3, device=cuda)
    kw = dict(lr=lr, beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True)
    args = [ks[k] for k in ("p", "g", "m1", "m2", "b1", "b2")]
    n = mt.multi_tensor_adam.launches
    with pytest.raises(ValueError, match="dtype"):
        mt.multi_tensor_adam(*args[:1], [ks["g"][0].double(), ks["g"][1]],
                             *args[2:], [0.0, 0.0], **kw)
    with pytest.raises(ValueError, match="moments"):
        mt.multi_tensor_adam(*args[:3], [ks["m2"][0].bfloat16(),
                                         ks["m2"][1]], *args[4:],
                             [0.0, 0.0], **kw)
    with pytest.raises(ValueError, match="lr"):
        mt.multi_tensor_adam(*args, [0.0, 0.0], **dict(kw, lr=lr.cpu()))
    with pytest.raises(ValueError, match="scale"):
        mt.multi_tensor_adam(*args, [0.0, 0.0], clip=("norm", 1.0),
                             **{k: v for k, v in kw.items()})
    with pytest.raises(ValueError, match="expected"):
        mt.multi_tensor_unscale_norm([torch.ones(4, device=cuda),
                                      torch.ones(4)])
    assert mt.multi_tensor_adam.launches == n


def test_optimizer_kernels_take_tensors_that_are_not_contiguous(cuda):
    """Transposed parameters and moments, strided gradients: O1 unscales
    them in place and O2 updates them in place through contiguous
    copies, bit-equal to the plain versions, one launch each."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    g = torch.Generator(device=cuda).manual_seed(12)

    def make(shape, dt, scale=1.0, positive=False):
        x = (torch.rand if positive else torch.randn)(
            shape, generator=g, device=cuda) * scale
        return x.to(dt)

    shapes = [(64, 48), (33, 5), (1, 7)]
    ks = {"p": [make(s, torch.bfloat16).t() for s in shapes],
          "g": [make((s[1], 2 * s[0]), torch.bfloat16, 1024.0)[:, ::2]
                for s in shapes],
          "m1": [make(s, torch.float32, 0.1).t() for s in shapes],
          "m2": [make(s, torch.float32, 0.01, True).t() for s in shapes],
          "b1": [torch.full((), 0.9 ** 3, device=cuda) for _ in shapes],
          "b2": [torch.full((), 0.999 ** 3, device=cuda) for _ in shapes]}
    ps = {k: [t.clone() for t in v] for k, v in ks.items()}
    assert not any(t.is_contiguous() for t in ks["p"][:2] + ks["g"])
    n1, n2 = mt.multi_tensor_unscale_norm.launches, \
        mt.multi_tensor_adam.launches
    clip = ("global_norm", 1.0)
    inv = torch.full((), 1 / 1024.0, device=cuda)
    table = mt.AdamTable(ks["p"], ks["m1"], ks["m2"], ks["b1"], ks["b2"],
                         [0.01, 0.0, 0.01])
    table.set_grads(ks["g"])
    rk = table.unscale_norm(inv, clip)
    rr = mt.multi_tensor_unscale_norm_reference(ps["g"], inv, clip)
    torch.testing.assert_close(rk.scale, rr.scale, rtol=1e-6, atol=0)
    kw = dict(lr=torch.full((), 1e-3, device=cuda), beta1=0.9, beta2=0.999,
              epsilon=1e-8, decoupled=True, clip=clip, scale=rk.scale,
              found=[rk.found])
    table.adam(**kw)
    mt.multi_tensor_adam_reference(ps["p"], ps["g"], ps["m1"], ps["m2"],
                                   ps["b1"], ps["b2"], [0.01, 0.0, 0.01],
                                   **kw)
    for k in ("p", "g", "m1", "m2", "b1", "b2"):
        for a, b in zip(ks[k], ps[k]):
            assert torch.equal(a, b), k
    assert (mt.multi_tensor_unscale_norm.launches - n1,
            mt.multi_tensor_adam.launches - n2) == (2, 1)


def test_f16_and_transposed_parameters_step_through_the_kernels(cuda):
    """Adam and AdamW over f16 parameters (f16 or f32 moments) and over
    transposed parameters take the kernels, no fallback counted, and
    equal the loop (FLAGS_fused_optimizer=0) on the card bit for bit."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import Adam
    c = metrics.default_registry().get("optimizer.fallbacks_total")
    total = 0 if c is None else c.total()
    for cls, dtype, multi, transposed in ((Adam, torch.float16, True, False),
                                          (AdamW, torch.float16, False,
                                           False),
                                          (AdamW, torch.bfloat16, True,
                                           True)):
        runs = []
        for fused in (True, False):
            set_flags({"FLAGS_fused_optimizer": fused})
            try:
                ks = _opt_table(cuda, [4096, 33, 1], dtype, dtype, 13)
                ps = [(p.view(64, 64).t() if transposed and p.numel() == 4096
                       else p).clone().requires_grad_() for p in ks["p"]]
                opt = cls(learning_rate=1e-2, parameters=ps,
                          weight_decay=0.01, multi_precision=multi,
                          grad_clip=ClipGradByGlobalNorm(1.0))
                n2 = mt.multi_tensor_adam.launches
                for s in range(3):
                    for p, gr in zip(ps, ks["g"]):
                        p.grad = (gr.view(p.shape) * (1 + s)).to(dtype)
                    opt.step()
                assert mt.multi_tensor_adam.launches - n2 == \
                    (3 if fused else 0)
                runs.append([p.detach() for p in ps])
            finally:
                set_flags({"FLAGS_fused_optimizer": True})
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    c = metrics.default_registry().get("optimizer.fallbacks_total")
    assert (0 if c is None else c.total()) == total


def test_adamw_step_through_the_kernels_equals_the_loop_on_the_card(cuda):
    """Optimizer.step through O2 against FLAGS_fused_optimizer=0 (the
    loop, torch's CUDA ops) on the same card: bit-equal."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import ClipGradByValue
    from paddle_tpu_torch.optimizer import lr as tlr
    runs = []
    for fused in (True, False):
        set_flags({"FLAGS_fused_optimizer": fused})
        try:
            ks = _opt_table(cuda, [4096, 33, 1], torch.bfloat16,
                            torch.bfloat16, 10)
            ps = [p.clone().requires_grad_() for p in ks["p"]]
            sched = tlr.CosineAnnealingDecay(1e-2, T_max=10)
            opt = AdamW(learning_rate=sched, parameters=ps,
                        multi_precision=False,
                        grad_clip=ClipGradByValue(0.5))
            for s in range(3):
                for p, g in zip(ps, ks["g"]):
                    p.grad = g * (1 + s)
                opt.step()
                sched.step()
            runs.append([p.detach() for p in ps])
        finally:
            set_flags({"FLAGS_fused_optimizer": True})
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_grad_scaler_step_and_update_never_sync(cuda):
    """GradScaler.step / update and a scheduler step under
    torch.cuda.set_sync_debug_mode("error"), through the kernels; a
    planted inf skips the step and halves the scale."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as tlr
    ks = _opt_table(cuda, [4096, 33], torch.bfloat16, torch.float32, 11,
                    2.0 ** 10)
    ps = [p.clone().requires_grad_() for p in ks["p"]]
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10),
                             warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=ps,
                grad_clip=ClipGradByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                        decr_every_n_nan_or_inf=1)
    for s in range(3):
        for p, g in zip(ps, ks["g"]):
            p.grad = g.clone()
        if s == 2:
            ps[1].grad[4] = float("inf")
            kept = [p.detach().clone() for p in ps]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scaler.step(opt)
            scaler.update()
            sched.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(kept, ps))
    assert float(scaler._scale) == 2.0 ** 9


# -- the paddle-API eager core and GPT on it ---------------------------------

def test_eager_core_on_the_card_matches_the_cpu(cuda):
    """The eager core's ops and gradients on the card equal the same
    calls on the CPU (f32, TF32 off), and land on the card by default."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    prev = device._current
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((8, 16)).astype(np.float32)
    b_np = rng.standard_normal((16, 4)).astype(np.float32)
    outs = []
    try:
        for where in ("gpu", "cpu"):
            paddle.set_device(where)
            a = paddle.to_tensor(a_np, stop_gradient=False)
            b = paddle.to_tensor(b_np, stop_gradient=False)
            h = paddle.nn.functional.gelu(paddle.matmul(a, b))
            loss = (paddle.topk(h, 2, axis=1)[0].sum()
                    + paddle.logsumexp(h, axis=0).mean())
            loss.backward()
            outs.append([t.numpy() for t in (h, loss, a.grad, b.grad)])
            assert (a.place == paddle.CUDAPlace(torch.cuda.current_device())
                    if where == "gpu" else a.place == paddle.CPUPlace())
    finally:
        device._current = prev
    for g, c in zip(*outs):
        np.testing.assert_allclose(g, c, atol=1e-5, rtol=1e-5)


def test_gpt_step_through_the_kernels_matches_the_plain_sdpa(cuda):
    """A tiny bf16 GPT at head dim 128 (the 13B geometry's) through K1b
    and K2b (TMA launches = layers) against the same step through the
    plain sdpa: loss within 1e-2, every gradient within 5e-2 relative
    RMS (chip_smoke's gpt_train limits)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    prev = device._current
    try:
        paddle.set_device("gpu")
        paddle.seed(0)
        model = GPTForCausalLM(GPTConfig.tiny(
            hidden_size=256, num_attention_heads=2,
            max_position_embeddings=256))
        model.bfloat16()
        crit = paddle.nn.CrossEntropyLoss()
        ids = paddle.to_tensor(np.random.default_rng(1).integers(
            0, 128, (2, 256)))
        runs = []
        for flash in (True, False):
            for blk in model.blocks:
                blk.attn.use_flash = flash
            before = (tfa.flash_attention_fwd.tma_launches,
                      tfa.flash_attention_bwd_dkv.tma_launches)
            loss = crit(model(ids).reshape([-1, 128]), ids.reshape([-1]))
            loss.backward()
            got = (tfa.flash_attention_fwd.tma_launches - before[0],
                   tfa.flash_attention_bwd_dkv.tma_launches - before[1])
            assert got == ((2, 2) if flash else (0, 0))
            runs.append((float(loss), [p.grad._t.float() for p in
                                       model.parameters()]))
            model.clear_gradients()
    finally:
        device._current = prev
    (lk, gk), (lr_, gr) = runs
    assert abs(lk - lr_) <= 1e-2 * abs(lr_)
    for a, b in zip(gk, gr):
        rel = float((a - b).square().mean().sqrt()
                    / b.square().mean().sqrt().clamp(min=1e-30))
        assert rel <= 5e-2


# -- the high-level trainer on whole-step CUDA graphs (CapturedStep) --------

_FIT_CFG = dict(vocab_size=4096, hidden_size=256, num_attention_heads=2,
                intermediate_size=512, num_hidden_layers=2,
                max_position_embeddings=128)


@pytest.fixture
def fit_env(cuda):
    """The eager core on the card, the capture flags restored after."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    prev = device._current
    flags = paddle.get_flags(["FLAGS_sot_capture",
                              "FLAGS_sot_capture_cache"])
    paddle.set_device("gpu")
    yield paddle
    paddle.set_flags(flags)
    device._current = prev
    torch.cuda.set_sync_debug_mode("default")


def _fit_model(paddle, capture, dropout=0.0, sched=None, scaler=None,
               loss_scale=None, amp="O1"):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    paddle.set_flags({"FLAGS_sot_capture": capture})
    paddle.seed(0)
    net = GPTForCausalLM(GPTConfig(dropout=dropout, **_FIT_CFG))
    opt = paddle.optimizer.AdamW(
        sched if sched is not None else 1e-3, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    crit = paddle.nn.CrossEntropyLoss()
    V = _FIT_CFG["vocab_size"]

    def loss(logits, labels):
        out = crit(logits.reshape([-1, V]), labels.reshape([-1]))
        return out if loss_scale is None else out * paddle.Tensor(
            loss_scale)
    cfg = amp if scaler is None else {"level": amp, "scaler": scaler}
    return paddle.Model(net).prepare(opt, loss, amp_configs=cfg), net, opt


def _fit_batches(paddle, n, seq=128):
    ids = np.random.default_rng(0).integers(0, 512, (4 * n, seq))
    return [(paddle.to_tensor(ids[4 * i:4 * i + 4]),) * 2 for i in range(n)]


def _train(model, batches, strict_from=2):
    losses = []
    for i, (x, y) in enumerate(batches):
        if i >= strict_from:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(model.train_batch(x, y)[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return losses


def test_captured_fit_matches_eager_bit_for_bit(fit_env):
    """Model.fit with O1 through CUDA graphs against FLAGS_sot_capture=0:
    the same losses, parameters and launch counts (K1b/K2b and O1/O2
    through the replays), one train and one eval graph, no sync in the
    replays."""
    paddle = fit_env
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    runs = []
    for capture in (True, False):
        model, net, opt = _fit_model(paddle, capture)
        before = (tfa.flash_attention_fwd.tma_launches,
                  tfa.flash_attention_bwd_dq.tma_launches,
                  mt.multi_tensor_adam.launches)
        losses = [float(v) for v in _train(model, _fit_batches(paddle, 5))]
        model.evaluate(paddle.io.DataLoader(_EvalIds(), batch_size=4),
                       verbose=0)
        counts = (tfa.flash_attention_fwd.tma_launches - before[0],
                  tfa.flash_attention_bwd_dq.tma_launches - before[1],
                  mt.multi_tensor_adam.launches - before[2])
        runs.append((losses, [p._t.detach().clone()
                              for p in net.parameters()], counts,
                     model._captured.stats, model._captured.graphs()))
    (lc, pc, cc, st, gr), (le, pe, ce, _, _) = runs
    assert lc == le and all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert cc == ce == (2 * (5 + 3), 2 * 5, 5)
    assert st["captured_steps"] == 4 + 2 and st["fallbacks"] == {}
    assert gr == {"train": 1, "eval": 1}


class _EvalIds:
    """Three eval batches of ids."""

    def __init__(self):
        self.ids = np.random.default_rng(5).integers(0, 512, (12, 128))

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return self.ids[i], self.ids[i]


def test_lr_change_between_replays_reaches_the_graph(fit_env):
    """A StepDecay stepped every batch: the replays read the new lr (the
    host refreshes the device scalar outside the graph)."""
    paddle = fit_env
    runs = []
    for capture in (True, False):
        sched = paddle.optimizer.lr.StepDecay(1e-3, step_size=1, gamma=0.3)
        model, net, opt = _fit_model(paddle, capture, sched=sched)
        out = []
        for x, y in _fit_batches(paddle, 5):
            out.append(float(model.train_batch(x, y)[0]))
            sched.step()
        runs.append((out, [p._t.detach().clone() for p in net.parameters()],
                     opt._global_step))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2] == 5
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_shape_change_and_lru_eviction(fit_env):
    """A new sequence length is a new signature (eager, then its own
    graph); with FLAGS_sot_capture_cache=1 the old graph is evicted and
    its shape starts over; every lazy loss is its own tensor."""
    paddle = fit_env
    paddle.set_flags({"FLAGS_sot_capture_cache": 1})
    model, net, opt = _fit_model(paddle, True)
    a, b = _fit_batches(paddle, 1, 128)[0], _fit_batches(paddle, 1, 64)[0]
    losses = _train(model, [a, a, a, b, b, b, a, a], strict_from=99)
    st = model._captured.stats
    assert st["eager_steps"] == 3 and st["compiles"] == 3
    assert st["captured_steps"] == 5 and model._captured.graphs() == \
        {"train": 1}
    assert len({v._t.data_ptr() for v in losses}) == len(losses)
    vals = [float(v) for v in losses]
    assert all(np.isfinite(vals)) and len(set(vals)) == len(vals)


def test_grad_scaler_skips_an_inf_step_under_capture(fit_env):
    paddle = fit_env
    poison = torch.ones((), device="cuda")
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15,
                                   decr_every_n_nan_or_inf=1)
    model, net, opt = _fit_model(paddle, True, scaler=scaler,
                                 loss_scale=poison)
    scales, same = [], None
    for i, (x, y) in enumerate(_fit_batches(paddle, 5)):
        poison.fill_(float("inf") if i == 3 else 1.0)
        before = [p._t.detach().clone() for p in net.parameters()]
        model.train_batch(x, y)
        scales.append(float(scaler._scale))
        moved = [not torch.equal(a, p._t)
                 for a, p in zip(before, net.parameters())]
        if i == 3:
            same = not any(moved)
        else:
            assert any(moved)
    assert same and scales == [2.0 ** 15] * 3 + [2.0 ** 14] * 2
    assert model._captured.stats["captured_steps"] == 4
    assert opt._global_step == 5


def test_dropout_model_is_counted_rng(fit_env):
    """A GPT with dropout 0.1 through Model.train_batch: its hash dropout
    draws device keys, so its steps are captured (no ``"rng"``), with
    the losses and parameters of the same steps run eager from the same
    seed."""
    paddle = fit_env
    runs = []
    for capture in (True, False):
        model, net, opt = _fit_model(paddle, capture, dropout=0.1)
        losses = [float(v) for v in _train(model, _fit_batches(paddle, 4))]
        runs.append((losses, [p._t.detach().clone()
                              for p in net.parameters()],
                     dict(model._captured.stats)))
    (lc, pc, st), (le, pe, _) = runs
    assert st["fallbacks"] == {} and st["captured_steps"] == 3
    np.testing.assert_allclose(lc, le, rtol=1e-5)
    assert len(set(lc)) == len(lc)
    for a, b in zip(pc, pe):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# -- TrainStep on CapturedStep, dropout keys on the card -------------------

def _tiny_bert_step(cuda, lr, seed=0):
    """A 2-layer BERT at head dim 64 in bf16 with dropout 0.1 (hash dropout
    and K5 inside the TMA flash kernels) and its TrainStep."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.nn import CrossEntropyLoss
    cfg = BertConfig.tiny(hidden_size=256, num_attention_heads=4,
                          intermediate_size=512, dropout=0.1)
    model = BertForMaskedLM(cfg, device=cuda, dtype=torch.bfloat16,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(seed))
    crit = CrossEntropyLoss()

    def make_opt():
        return AdamW(learning_rate=lr, parameters=model.named_parameters(),
                     multi_precision=False)
    ids = torch.randint(0, 128, (4, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    return model, crit, make_opt, ids


def _replay_strictly(step, ids, n):
    out = []
    for _ in range(n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out.append(step(ids, ids))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [float(v) for v in out]


def test_captured_bert_train_step_with_dropout_matches_its_eager_loop(cuda):
    """Five TrainSteps (one eager, one captured and replayed, three
    replays with no host sync) against the same five steps through a
    plain eager loop from the same weights and seed: the same losses and
    parameters, the same stream state after; dropout launches counted
    through the replays."""
    from paddle_tpu_torch.core import random as trandom
    model, crit, make_opt, ids = _tiny_bert_step(cuda, 1e-3)
    start = [p.detach().clone() for p in model.parameters()]
    step = TrainStep(model, crit, make_opt())
    trandom.seed(7)
    d0 = tfa.flash_attention_fwd.dropout_launches
    losses = [float(step(ids, ids))] + _replay_strictly(step, ids, 4)
    assert tfa.flash_attention_fwd.dropout_launches - d0 == 2 * 5
    st = step.stats
    assert st["captured_steps"] == 4 and st["fallbacks"] == {}
    assert step._step.graphs() == {"train": 1}
    cap = [p.detach().clone() for p in model.parameters()]
    cap_state = trandom.get_rng_state()
    with torch.no_grad():
        for p, s0 in zip(model.parameters(), start):
            p.copy_(s0)
    opt = make_opt()
    trandom.seed(7)
    eager = []
    for _ in range(5):
        loss = crit(model(ids), ids).float()
        loss.backward()
        for p in opt._parameter_list:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        eager.append(float(loss.detach()))
    np.testing.assert_allclose(losses, eager, rtol=1e-3)
    assert trandom.get_rng_state() == cap_state
    for a, b in zip(cap, model.parameters()):
        torch.testing.assert_close(a.float(), b.detach().float(),
                                   rtol=2e-2, atol=2e-3)


def test_train_step_replays_draw_fresh_masks(cuda):
    """With lr 0 the weights stay: every replay's loss differs from the
    others (a fresh dropout key each replay, drawn on the card), and the
    n-th equals the n-th eager step's from the same seed."""
    from paddle_tpu_torch.core import random as trandom
    model, crit, make_opt, ids = _tiny_bert_step(cuda, 0.0)
    step = TrainStep(model, crit, make_opt())
    trandom.seed(3)
    got = [float(step(ids, ids))] + _replay_strictly(step, ids, 4)
    assert step.stats["captured_steps"] == 4
    assert len(set(got)) == len(got)
    trandom.seed(3)
    want = []
    for _ in range(5):
        with torch.no_grad():
            want.append(float(crit(model(ids), ids).float()))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_manual_seed_between_replays_restarts_the_stream(cuda):
    """A reseed writes the generator's state on the card in place: the
    graph holds the same address, so it is not captured again, and its
    replays draw the stream from its start again."""
    from paddle_tpu_torch.core import random as trandom
    model, crit, make_opt, ids = _tiny_bert_step(cuda, 0.0)
    step = TrainStep(model, crit, make_opt())
    trandom.seed(11)
    first = [float(step(ids, ids))] + _replay_strictly(step, ids, 3)
    trandom.seed(11)
    again = _replay_strictly(step, ids, 3)
    assert step.stats["compiles"] == 1
    assert step.stats["captured_steps"] == 3 + 3
    np.testing.assert_allclose(again, first[:3], rtol=1e-4)
    assert again[1] == first[1] and again[2] == first[2]


def _vision_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(4, 9, 9, 8, generator=g),
            torch.randn(16, 8, 3, 3, generator=g),
            torch.randn(8, 4, 3, 3, generator=g))


def test_vision_functionals_on_the_card_match_the_cpu(cuda):
    """NHWC conv (stride 2, 'SAME'), transposed conv, max pool with
    ReLU ties, average and adaptive pools and a training batch norm in
    f32 (TF32 off): outputs and input gradients within 1e-4 of the same
    calls on the CPU (cuDNN adds in another order)."""
    import paddle_tpu_torch.nn.functional as F
    x, w, wt = _vision_inputs()
    outs = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        rm = torch.zeros(16, device=dev)
        rv = torch.ones(16, device=dev)
        y = F.conv2d(xd, w.to(dev).contiguous(
            memory_format=torch.channels_last), stride=2, padding="SAME",
            data_format="NHWC")
        y = F.batch_norm(y, rm, rv, training=True, data_format="NHWC")
        y = F.relu(y)
        p = F.max_pool2d(y, 3, 2, 1, data_format="NHWC")
        a = F.avg_pool2d(y, 2, 2, ceil_mode=True, data_format="NHWC")
        c = F.adaptive_avg_pool2d(y, 1, data_format="NHWC")
        t = F.conv2d_transpose(x.to(dev).permute(0, 3, 1, 2), wt.to(dev),
                               stride=2, padding=1, output_padding=1)
        loss = p.square().sum() + a.sum() + c.sum() + t.square().mean()
        loss.backward()
        outs.append([v.detach().cpu() for v in (p, a, c, t, xd.grad, rm,
                                                 rv)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_batch_norm_on_the_card_makes_no_host_read(cuda):
    """Forward (a cold anchor takes the repair) and backward under
    ``set_sync_debug_mode("error")``: no device value reaches the
    host."""
    from paddle_tpu_torch.nn import BatchNorm2D
    bn = BatchNorm2D(8, data_format="NHWC").to(cuda)
    x = (torch.randn(16, 5, 5, 8, device=cuda) + 300).requires_grad_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bn(x).square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(x.grad).all() and bn._mean.abs().min() > 10


def test_captured_resnet_train_step_matches_its_eager_loop(cuda):
    """A ResNet-18 at 32×32, NHWC, bf16 with ``Momentum`` through
    ``TrainStep``: one eager step, the capture, three replays with no
    host sync, no fallback; then the same five steps through a plain eager loop from
    the same start. With cuDNN deterministic both run the same kernels
    in the same order: losses, parameters, velocities and running
    statistics bit for bit."""
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    torch.backends.cudnn.deterministic = True
    prev = tdevice._current
    tdevice.set_device("gpu")
    try:
        torch.manual_seed(0)
        model = resnet18(num_classes=10, data_format="NHWC").bfloat16()
        start = {k: v.detach().clone()
                 for k, v in model.state_dict(keep_vars=True,
                                              prefix="").items()}
        g = torch.Generator(device=cuda).manual_seed(1)
        x = (torch.randn(8, 32, 32, 3, device=cuda, generator=g)
             * 0.1).bfloat16()
        y = torch.randint(0, 10, (8,), device=cuda, generator=g)
        crit = CrossEntropyLoss()

        def make_opt():
            return Momentum(0.1, 0.9, parameters=model.parameters())
        opt = make_opt()
        step = TrainStep(model, crit, opt)
        # the first call runs eager, the second captures (its set-up may
        # copy to the card), the rest replay without a host sync
        losses = [float(step(x, y)) for _ in range(2)] + \
            _replay_strictly_xy(step, x, y, 3)
        st = step.stats
        assert st["captured_steps"] == 4 and st["fallbacks"] == {}
        got = {k: v.detach().clone() for k, v in model.state_dict(
            keep_vars=True, prefix="").items()}
        vel = [s["velocity"].clone() for _, s in sorted(opt._states.items())]
        with torch.no_grad():
            for k, v in model.state_dict(keep_vars=True, prefix="").items():
                v.copy_(start[k])
        opt = make_opt()
        eager = []
        for _ in range(5):
            loss = crit(model(x), y).float()
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(float(loss.detach()))
        assert losses == eager
        for k, v in model.state_dict(keep_vars=True, prefix="").items():
            assert torch.equal(v, got[k]), k
        assert not torch.equal(got["bn1._mean"], start["bn1._mean"])
        for a, (_, s) in zip(vel, sorted(opt._states.items())):
            assert torch.equal(a, s["velocity"])
    finally:
        tdevice._current = prev
        torch.backends.cudnn.deterministic = False


def _replay_strictly_xy(step, x, y, n):
    out = []
    for _ in range(n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out.append(step(x, y))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [float(v) for v in out]


# -- dy2static and the inference artifact -------------------------------------

def _tiny_gpt(paddle, head_dim):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(0)
    model = GPTForCausalLM(GPTConfig.tiny(
        hidden_size=2 * head_dim, num_attention_heads=2,
        max_position_embeddings=256))
    model.bfloat16()
    model.eval()
    ids = paddle.to_tensor(np.random.default_rng(2).integers(
        0, 128, (2, 256)))
    return model, ids


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_flash_operator_launches_what_the_wrapper_does(cuda, causal,
                                                       head_dim):
    """``paddle_tpu_torch::flash_fwd`` on the card: bit-equal to the
    wrapper (the TMA design, counted once a call) and within the bf16
    limits of the plain walk."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((2, 256, 3 * 2 * head_dim), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (x.view(2, 256, 2, head_dim)
               for x in qkv.split(2 * head_dim, dim=-1))
    before = tfa.flash_attention_fwd.tma_launches
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd(
        q, k, v, causal, None, 0.0, None, None, None)
    assert tfa.flash_attention_fwd.tma_launches == before + 1
    w_out, w_lse = tfa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(out, w_out) and torch.equal(lse, w_lse)
    ref, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_exported_gpt_launches_the_flash_kernel(cuda, head_dim, tmp_path):
    """A tiny bf16 GPT saved with ``aot=True`` and served by its exported
    program: K1a (D 64) / K1b (D 128) launched once a layer, counted,
    and the logits bit-equal to the eager forward's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    from paddle_tpu_torch.inference import save_inference_model
    from paddle_tpu_torch.jit import InputSpec, TranslatedLayer
    prev = device._current
    try:
        paddle.set_device("gpu")
        model, ids = _tiny_gpt(paddle, head_dim)
        with paddle.no_grad():
            want = model(ids)._t
        path = str(tmp_path / "gpt")
        save_inference_model(path, model, input_spec=[
            InputSpec([2, 256], "int64")], aot=True)
        tl = TranslatedLayer.load(path)
        before = tfa.flash_attention_fwd.tma_launches
        got = tl(ids)._t
        assert tfa.flash_attention_fwd.tma_launches == before + 2
        assert got.device.type == "cuda"
        assert torch.equal(got, want)
    finally:
        device._current = prev


def test_to_static_replays_cuda_graphs(cuda):
    """SOT on the card: record, one op-by-op replay, then CUDA-graph
    replays (K1b counted through them), bit-equal to eager; a replay
    that needs gradients stays op by op and differentiable."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    prev = device._current
    try:
        paddle.set_device("gpu")
        model, ids = _tiny_gpt(paddle, 128)
        with paddle.no_grad():
            want = model(ids)._t
        paddle.jit.to_static(model)
        before = tfa.flash_attention_fwd.launches
        with paddle.no_grad():
            outs = [model(ids)._t for _ in range(5)]
        assert tfa.flash_attention_fwd.launches == before + 2 * 5
        st = model.forward.stats
        assert (st["records"], st["op_replays"], st["graph_replays"]) == \
            (1, 1, 3)
        assert st["segment_captures"] == 1 and not st["fallbacks"]
        assert all(torch.equal(o, want) for o in outs)
        # outputs are the caller's: a later replay does not overwrite them
        assert outs[2].data_ptr() != outs[3].data_ptr()
        out = model(ids)                       # with gradients
        assert model.forward.stats["op_replays"] == 2
        out.astype("float32").mean().backward()
        assert model.blocks[0].attn.qkv_proj.weight.grad is not None
    finally:
        device._current = prev


def test_to_static_guards_take_one_fetch(cuda):
    """A branch on a device value: both paths replay as graphs, a miss
    is counted, and each guarded replay reads one packed tensor."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    prev = device._current
    try:
        paddle.set_device("gpu")

        @paddle.jit.to_static
        def f(x):
            y = paddle.tanh(x) * 2
            if y.sum() > 0:
                return y + 1
            return y - 1

        xs = [paddle.to_tensor(np.full((64, 64), s, np.float32))
              for s in (1.0, -1.0)]
        with paddle.no_grad():
            for i in range(8):
                x = xs[i % 2]
                want = (np.tanh(x.numpy()) * 2 + (1 if i % 2 == 0 else -1))
                np.testing.assert_allclose(f(x).numpy(), want, rtol=1e-6)
        st = f.stats
        assert st["records"] == 2 and st["guard_misses"] >= 1
        assert st["graph_replays"] >= 1 and st["segment_captures"] >= 2
        assert st["guard_fetches"] == st["op_replays"] + \
            st["graph_replays"] + st["guard_misses"]
    finally:
        device._current = prev


def test_full_graph_static_function_is_one_graph(cuda):
    """``to_static(full_graph=True)`` on the card: eager first, then one
    graph replayed, bit-equal; a parameter rebound to new storage makes
    a new capture."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device
    prev = device._current
    try:
        paddle.set_device("gpu")
        model, ids = _tiny_gpt(paddle, 128)
        with paddle.no_grad():
            want = model(ids)._t
        st = paddle.jit.to_static(model, full_graph=True)
        outs = [st(ids)._t for _ in range(4)]
        assert all(torch.equal(o, want) for o in outs)
        assert (st.stats["eager_calls"], st.stats["captures"],
                st.stats["replays"]) == (1, 1, 3)
        w = model.lm_head.weight
        w._t.data = w._t.data.clone() * 0
        out = st(ids)._t
        assert st.stats["captures"] == 2 and float(out.abs().max()) == 0.0
    finally:
        device._current = prev


# ---------------------------------------------------------------------------
# the serving step as CUDA graphs (capture_jit), K3 as an operator, int8
# ---------------------------------------------------------------------------

def test_k3_operator_reads_its_tile_count_inside_a_graph(cuda):
    """``paddle_tpu_torch::paged_attention`` on the card equals the
    wrapper's direct launch; captured in a CUDA graph it reads
    ``n_tiles`` from device memory (a new value written into the same
    tensor changes the replay's result to the direct call's at that
    value), and the counters advance only where it launches."""
    (q, kp, vp, tables, pos), kw = _inputs(cuda, 2, 1, 8, 2, 128, 16, 6,
                                           torch.bfloat16, False, 3)
    pos = torch.full_like(pos, 70)     # history past the first 2 tiles
    nt = torch.full((1,), 6, dtype=torch.int32, device=cuda)
    args = (q, kp, vp, tables, pos, nt, None, None, 16, 4)
    want = tpk._launch(*args)
    got = torch.ops.paddle_tpu_torch.paged_attention(*args)
    assert torch.equal(got, want)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpk.paged_attention_op(*args)          # warm the stream
        before = tpk.paged_attention_kernel.launches
        with torch.cuda.graph(g, stream=side):
            out = tpk.paged_attention_op(*args)
    torch.cuda.current_stream().wait_stream(side)
    assert tpk.paged_attention_kernel.launches == before + 1
    for n in (6, 2):
        nt.fill_(n)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tpk._launch(*args))
    assert not torch.equal(out, want)


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 40])
def test_int_mm_padding_is_exact(cuda, rows):
    """``_s8_matmul`` pads fewer than 24 rows for ``torch._int_mm`` and
    gives the exact int32 product at every row count."""
    from paddle_tpu_torch.serving import _s8_matmul
    g = torch.Generator(device=cuda).manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 256), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (72, 256), generator=g, device=cuda,
                      dtype=torch.int8)
    got = _s8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (rows, 72)
    want = (a.double() @ w.double().t()).to(torch.int64)
    assert torch.equal(got.to(torch.int64), want)


def test_capture_jit_replays_and_recaptures_on_a_moved_tensor(cuda):
    """A program's first call runs op by op and captures; later calls
    replay with the small inputs copied in; a donated output comes back
    as the caller's tensor; a donated tensor that moved captures anew and
    the stale graph never replays."""
    from paddle_tpu_torch.jit.sot import capture_jit

    def body(w, buf, x):
        buf.add_(w * x)
        return (w * x).sum(), buf

    w = torch.arange(4.0, device=cuda)
    buf = torch.zeros(4, device=cuda)
    prog = capture_jit(body, donate_argnums=(0, 1), name="t.card")
    for i in range(3):
        s, out = prog(w, buf, np.full(4, i + 1, np.float32))
        assert out is buf and float(s) == 6.0 * (i + 1)
    assert buf.tolist() == [0.0, 6.0, 12.0, 18.0]
    assert prog.stats["captures"] == 1 and prog.stats["replays"] == 2
    w2 = torch.ones(4, device=cuda)
    s, _ = prog(w2, buf, np.ones(4, np.float32))
    assert float(s) == 4.0 and prog.stats["captures"] == 2
    assert prog._group.graphs() == 1 and prog._group.pool_bytes() > 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_captured_serving_equals_eager_on_the_card(cuda, int8):
    """A target with make_draft()'s view through a speculative server,
    and the dense engine's window: the captured engines' streams equal
    the same engines run op by op (``FLAGS_sot_capture=0``), every
    program replayed its graph, nothing fell back, and the K3 launches
    of the replays count as the eager launches."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.serving import LlamaDecodeEngine
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, dtype="bfloat16",
                           use_flash_attention=False)
    model = LlamaForCausalLM(cfg, device="cuda")
    prompts = [(list(range(1, 40)), 20), (list(range(7, 12)), 9)]
    runs = {}
    for mode in ("eager", "captured"):
        set_flags({"FLAGS_sot_capture": mode == "captured"})
        try:
            eng = PagedLlamaDecodeEngine(model, int8=int8, **_SPEC_GEO)
            eng.attach_draft(eng.make_draft(), spec_tokens=3)
            before = tpk.paged_attention_kernel.launches
            srv = GenerationServer(eng)
            try:
                streams = [srv.generate(p, n, timeout=120)
                           for p, n in prompts]
            finally:
                assert srv.shutdown(timeout=60)
            dense = LlamaDecodeEngine(model, 2, 128, int8, device="cuda")
            dense.prefill(0, prompts[0][0])
            dense.prefill(1, prompts[1][0])
            window = dense.decode_steps(5).tolist()
            runs[mode] = (streams, window,
                          tpk.paged_attention_kernel.launches - before,
                          eng._graphs.stats(), eng._draft._graphs.stats(),
                          dense._graphs.stats())
        finally:
            set_flags({"FLAGS_sot_capture": True})
    assert runs["captured"][:3] == runs["eager"][:3]
    for st in runs["captured"][3:]:
        assert st["fallbacks"] == 0 and st["replays"] > 0
        assert st["captures"] == st["graphs"]
    by = runs["captured"][3]["by_program"]
    assert by["serving.spec_verify"]["replays"] > 0
    assert by["serving.paged_prefill"]["captures"] >= 1
    assert runs["captured"][4]["by_program"]["serving.spec_draft"][
        "replays"] > 0
    # the replays' K3 launches, as their captures counted them, are a
    # part of the run's launches
    replayed = sum(v["replayed"].get("paged_attention_kernel.launches", 0)
                   for st in runs["captured"][3:]
                   for v in st["by_program"].values())
    assert 0 < replayed <= runs["captured"][2]


def test_export_decode_on_the_card(cuda):
    """The paged engine's exported decode step, loaded from its bytes,
    runs K3 on the card through the operator and equals the live
    step."""
    import io
    from torch.utils import _pytree as pytree
    model = _tiny_llama_on_card()
    eng = PagedLlamaDecodeEngine(model, **_SPEC_GEO)
    eng.prefill(0, list(range(1, 40)), budget=8)
    eng._extend_tables()
    ep = torch.export.load(io.BytesIO(eng.export_decode()))
    args = list(eng._export_args())
    args[1] = pytree.tree_map(lambda t: t.clone(), args[1])
    before = tpk.paged_attention_kernel.launches
    nxt = ep.module()(*args)
    assert tpk.paged_attention_kernel.launches == \
        before + model.config.num_hidden_layers
    assert nxt.tolist() == eng.step().tolist()
    for got, live in zip(pytree.tree_leaves(args[1]),
                         pytree.tree_leaves(eng._kv_store)):
        assert torch.equal(got, live)


# -- the rest of paddle.vision ------------------------------------------------

def test_captured_mobilenet_v2_train_step_matches_its_eager_loop(cuda):
    """MobileNetV2 (scale 0.5, 10 classes) at 64×64, NCHW, bf16 with
    ``Momentum`` and L2 decay through ``TrainStep``: its depthwise
    convolutions and its classifier's hash dropout inside the graph,
    one eager step, the capture, three replays with no host sync, no
    fallback; then the same five steps through a plain eager loop from
    the same weights and the restored key stream (so the dropout masks
    are the same): losses, parameters, velocities and running
    statistics bit for bit (cuDNN deterministic)."""
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import mobilenet_v2
    torch.backends.cudnn.deterministic = True
    prev = tdevice._current
    tdevice.set_device("gpu")
    try:
        trandom.seed(0)
        model = mobilenet_v2(scale=0.5, num_classes=10).bfloat16()
        start = {k: v.detach().clone()
                 for k, v in model.state_dict(keep_vars=True,
                                              prefix="").items()}
        g = torch.Generator(device=cuda).manual_seed(1)
        x = (torch.randn(8, 3, 64, 64, device=cuda, generator=g)
             * 0.1).bfloat16()
        y = torch.randint(0, 10, (8,), device=cuda, generator=g)
        crit = CrossEntropyLoss()

        def make_opt():
            return Momentum(0.045, 0.9, parameters=model.parameters(),
                            weight_decay=4e-5)
        opt = make_opt()
        rng0 = trandom.get_rng_state()
        step = TrainStep(model, crit, opt)
        losses = [float(step(x, y)) for _ in range(2)] + \
            _replay_strictly_xy(step, x, y, 3)
        st = step.stats
        assert st["captured_steps"] == 4 and st["fallbacks"] == {}
        assert step._step.graphs() == {"train": 1}
        rng_cap = trandom.get_rng_state()
        got = {k: v.detach().clone() for k, v in model.state_dict(
            keep_vars=True, prefix="").items()}
        vel = [s["velocity"].clone() for _, s in sorted(opt._states.items())]
        with torch.no_grad():
            for k, v in model.state_dict(keep_vars=True, prefix="").items():
                v.copy_(start[k])
        opt = make_opt()
        trandom.set_rng_state(rng0)
        eager = []
        for _ in range(5):
            loss = crit(model(x), y).float()
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(float(loss.detach()))
        assert losses == eager
        assert trandom.get_rng_state() == rng_cap
        for k, v in model.state_dict(keep_vars=True, prefix="").items():
            assert torch.equal(v, got[k]), k
        assert not torch.equal(got["features.0._norm._mean"],
                               start["features.0._norm._mean"])
        for a, (_, s) in zip(vel, sorted(opt._states.items())):
            assert torch.equal(a, s["velocity"])
    finally:
        tdevice._current = prev
        torch.backends.cudnn.deterministic = False


def test_deform_conv2d_and_grid_sample_on_the_card_match_the_cpu(cuda):
    """``deform_conv2d`` with a mask (forward and the gradients of every
    input) and ``grid_sample`` in every mode × padding × corner
    alignment (forward and the input and grid gradients), f32 with TF32
    off: within 1e-4 · (1 + |ref|) of the same calls on the CPU, the
    gradients within 1e-3 · (1 + |ref|) (sums in other orders)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.ops import deform_conv2d
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 12, 12, generator=g)
    off = torch.randn(2, 18, 12, 12, generator=g) * 2
    w = torch.randn(6, 8, 3, 3, generator=g) * 0.2
    m = torch.rand(2, 9, 12, 12, generator=g)
    xs = torch.randn(2, 4, 9, 11, generator=g)
    grid = torch.rand(2, 7, 5, 2, generator=g) * 2.4 - 1.2

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_() for t in (x, off, w, m)]
        out = deform_conv2d(ins[0], ins[1], ins[2], stride=1, padding=1,
                            mask=ins[3])
        out.square().sum().backward()
        res = [out] + [t.grad for t in ins]
        for mode in ("bilinear", "nearest"):
            for pad in ("zeros", "border", "reflection"):
                for align in (True, False):
                    a = xs.detach().to(dev).requires_grad_()
                    gr = grid.detach().to(dev).requires_grad_(
                        mode == "bilinear")
                    o = F.grid_sample(a, gr, mode=mode, padding_mode=pad,
                                      align_corners=align)
                    o.square().sum().backward()
                    res += [o, a.grad] + ([gr.grad] if gr.requires_grad
                                          else [])
        return [r.detach().cpu() for r in res]
    got, want = run(cuda), run("cpu")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 if i == 0 else 1e-3
        assert ((a - b).abs() <= tol * (1 + b.abs())).all(), (
            i, float((a - b).abs().max()))


# -- recompute, ASP under capture, warm bundles -------------------------------

def _llama_recompute_losses(cuda, recompute):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512,
                           dtype="bfloat16", recompute=recompute)
    model = LlamaForCausalLM(cfg, device=cuda,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(0))
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    step = TrainStep(model, LlamaPretrainingCriterion(), opt)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda)
                        .manual_seed(1))
    losses = [float(step(ids, ids)) for _ in range(2)]
    tfa.flash_attention_fwd.launches = 0
    tfa.flash_attention_fwd.tma_launches = 0
    losses += _replay_strictly_xy(step, ids, ids, 2)
    assert step._step.graphs() == {"train": 1}
    assert step.stats["fallbacks"] == {}
    fwd = (tfa.flash_attention_fwd.launches,
           tfa.flash_attention_fwd.tma_launches)
    return losses, fwd, [p.detach().clone() for p in model.parameters()]


def test_recompute_replays_the_flash_forward_twice_a_layer(cuda):
    """A tiny bf16 Llama (D 128) through the captured TrainStep with and
    without ``recompute``: K1b's forward twice a layer a replay with it
    (all TMA), once without; losses and parameters bit-equal."""
    rc, fwd_rc, p_rc = _llama_recompute_losses(cuda, True)
    plain, fwd_plain, p_plain = _llama_recompute_losses(cuda, False)
    assert fwd_rc == (8, 8) and fwd_plain == (4, 4)
    assert rc == plain
    for a, b in zip(p_rc, p_plain):
        assert torch.equal(a, b)


def test_asp_masks_hold_inside_a_captured_step(cuda):
    """Two FusedTransformerEncoderLayers (D 64, dropout 0.1) with their
    FFN weights pruned 2:4 and an ``asp.decorate``d AdamW through the
    captured TrainStep: one graph, no fallback, the pruned entries still
    zero after the replays."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    prev = tdevice._current
    tdevice.set_device("gpu")
    try:
        paddle.seed(0)
        model = paddle.nn.Sequential(
            FusedTransformerEncoderLayer(128, 2, 256, dropout_rate=0.1),
            FusedTransformerEncoderLayer(128, 2, 256, dropout_rate=0.1))
        model.bfloat16()
        masks = {}
        for i in range(2):
            for k, m in asp.prune_model(model[i].ffn).items():
                masks[f"{i}.ffn.{k}"] = m
        assert len(masks) == 4
        params = dict(torch.nn.Module.named_parameters(model))
        opt = asp.decorate(AdamW(
            learning_rate=1e-2, parameters=torch.nn.Module.parameters(model)))
        step = TrainStep(model, lambda out, y: ((out - y) ** 2).mean(), opt)
        g = torch.Generator(device=cuda).manual_seed(2)
        x = torch.randn(4, 64, 128, device=cuda, generator=g).bfloat16()
        y = torch.randn(4, 64, 128, device=cuda, generator=g).bfloat16()
        for _ in range(2):
            step(x, y)
        _replay_strictly_xy(step, x, y, 3)
        assert step._step.graphs() == {"train": 1}
        assert step.stats["fallbacks"] == {}
        for k, m in masks.items():
            p = params[k]
            assert bool((p[m == 0] == 0).all()), k
            assert asp.check_sparsity(p), k
    finally:
        tdevice._current = prev


def test_nan_flags_queued_before_a_capture_are_kept_through_it(cuda):
    """``FLAGS_check_nan_inf`` at stride 8 with two flags queued when a
    TrainStep with a paddle-Tensor loss captures: the flush of the
    loss's ``backward`` inside the capture fetches nothing and keeps the
    queue, the capture holds (no fallback), the replays make no host
    sync, and the first flush after fetches the queue once."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import autograd as tag
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    tdevice.set_device("gpu")
    paddle.set_flags({"FLAGS_check_nan_inf": True,
                      "FLAGS_check_nan_inf_stride": 8})
    try:
        paddle.seed(0)
        net = paddle.nn.Sequential(paddle.nn.Linear(64, 128),
                                   paddle.nn.ReLU(), paddle.nn.Linear(128, 8))
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=net.parameters())
        step = TrainStep(net, paddle.nn.MSELoss(), opt)
        g = np.random.default_rng(0)
        x = paddle.to_tensor(g.standard_normal((16, 64)).astype(np.float32))
        y = paddle.to_tensor(g.standard_normal((16, 8)).astype(np.float32))
        step(x, y)                                  # the eager sighting
        tag.flush_nan_checks()
        x + 1.0
        x * 2.0
        assert len(tag._nan_pending) == 2
        f0 = tag._nan_fetches
        step(x, y)                                  # capture and replay
        _replay_strictly_xy(step, x, y, 2)
        assert step.stats["captured_steps"] == 3
        assert step.stats["fallbacks"] == {}
        assert len(tag._nan_pending) == 2 and tag._nan_fetches == f0
        tag.flush_nan_checks()
        assert not tag._nan_pending and tag._nan_fetches == f0 + 1
    finally:
        tag._nan_pending.clear()
        paddle.set_flags({"FLAGS_check_nan_inf": False,
                          "FLAGS_check_nan_inf_stride": 1})
        tdevice._current = prev


def test_warm_bundle_makes_the_first_step_a_replay(cuda, tmp_path):
    """A ``Model`` on the card records its train signature, exports the
    bundle; a fresh model pre-warmed from it is unchanged by the
    pre-warm, its first ``train_batch`` is a replay (no eager sighting),
    and its losses equal the cold model's bit for bit; the NaN scan with
    its flag on fetches nothing in the replays."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import autograd as tag
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.jit import warmup
    prev = tdevice._current
    tdevice.set_device("gpu")

    def make():
        paddle.seed(0)
        net = paddle.nn.Sequential(paddle.nn.Linear(64, 128),
                                   paddle.nn.ReLU(), paddle.nn.Linear(128, 8))
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=net.parameters())
        return net, opt
    g = np.random.default_rng(0)
    x = g.standard_normal((16, 64)).astype(np.float32)
    y = g.standard_normal((16, 8)).astype(np.float32)
    try:
        warmup.clear_recorded()
        net, opt = make()
        cold = paddle.Model(net).prepare(opt, paddle.nn.MSELoss())
        cold_losses = [float(cold.train_batch([x], [y])[0])
                       for _ in range(3)]
        path = warmup.export_bundle(str(tmp_path / "b.json"))
        warmup.clear_recorded()
        net2, opt2 = make()
        before = [p.detach().clone()
                  for p in torch.nn.Module.parameters(net2)]
        warm = paddle.Model(net2).prepare(opt2, paddle.nn.MSELoss(),
                                          warm_bundle=path)
        for a, b in zip(torch.nn.Module.parameters(net2), before):
            assert torch.equal(a, b)
        st = dict(warm._captured.stats)
        assert st["eager_steps"] == 1 and warm._captured.graphs() == \
            {"train": 1}
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        f0 = tag._nan_fetches
        try:
            losses = [float(warm.train_batch([x], [y])[0])
                      for _ in range(3)]
        finally:
            paddle.set_flags({"FLAGS_check_nan_inf": False})
        assert tag._nan_fetches == f0
        assert warm._captured.stats["eager_steps"] == 1
        assert warm._captured.stats["captured_steps"] == \
            st["captured_steps"] + 3
        assert losses == cold_losses
    finally:
        tdevice._current = prev


def test_device_draws_on_the_card_equal_the_cpus(cuda):
    """One key's bits are the same words on the card and on the CPU;
    its uniforms equal, its normals within 1e-6 of the CPU's (relative
    to max(1, |z|))."""
    from paddle_tpu_torch.core import random as trandom
    key = torch.tensor([0x243F6A88, 0x85A308D3], dtype=torch.int64)
    shape = (257, 1031)
    assert torch.equal(trandom.bits(shape, key=key.to(cuda)).cpu(),
                       trandom.bits(shape, key=key))
    assert torch.equal(trandom.uniform(shape, key=key.to(cuda)).cpu(),
                       trandom.uniform(shape, key=key))
    zc = trandom.normal(shape, key=key.to(cuda)).cpu()
    zh = trandom.normal(shape, key=key)
    assert float(((zc - zh).abs() / zh.abs().clamp(min=1)).max()) <= 1e-6
    assert torch.equal(trandom.permutation(4099, key=key.to(cuda)).cpu(),
                       trandom.permutation(4099, key=key))


def test_bernoulli_and_random_ops_are_captured_in_a_train_step(cuda):
    """Axis, downscale and alpha dropout, ``rrelu``, ``gumbel_softmax``
    and a random creation op inside a captured TrainStep: one graph, no
    fallback (no "rng"), fresh draws every replay, no host draw."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.core import random as trandom
    F = paddle.nn.functional
    prev = tdevice._current
    tdevice.set_device("gpu")
    try:
        paddle.seed(0)

        class Net(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = paddle.nn.Linear(16, 32)
                self.fc2 = paddle.nn.Linear(32, 16)

            def forward(self, x):
                h = self.fc1(x)
                h = F.dropout(h, 0.2, axis=1)
                h = F.dropout(h, 0.2, mode="downscale_in_infer")
                h = F.alpha_dropout(F.rrelu(h), 0.1)
                h = h + 1e-3 * paddle.rand(h.shape)
                h = h * F.gumbel_softmax(h, 0.5)
                return self.fc2(h)
        net = Net()
        opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
        step = TrainStep(net, lambda out, y: ((out - y) ** 2).mean(), opt)
        g = torch.Generator(device=cuda).manual_seed(3)
        x = paddle.Tensor(torch.randn(8, 16, device=cuda, generator=g))
        y = paddle.Tensor(torch.randn(8, 16, device=cuda, generator=g))
        for _ in range(2):
            step(x, y)
        d0 = trandom.draws()
        losses = [float(step(x, y)) for _ in range(3)]
        assert trandom.draws() == d0
        assert step._step.graphs() == {"train": 1}
        assert step.stats["fallbacks"] == {}
        assert len(set(losses)) == 3          # fresh masks each replay
    finally:
        tdevice._current = prev


def test_the_profiler_reads_the_card_and_the_memory_counters_agree(
        cuda, tmp_path):
    """``Profiler(targets=[GPUTrace])`` around a matmul: its device
    plane names the GEMM and the merged trace holds it beside the host
    step spans; ``paddle.device.cuda``'s counters are torch's."""
    import json
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profiler
    a = torch.randn(512, 512, device=cuda)
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.GPUTrace])
    prof.start()
    for _ in range(2):
        (a @ a).sum()
        prof.step()
    prof.stop()
    rows = prof.device_events()
    assert rows and all(e["pid"] == 1 for e in rows)
    path = prof.export(str(tmp_path / "t.json"))
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    assert sum(1 for e in ev if e.get("name", "").startswith(
        "ProfileStep#")) == 2
    assert sum(1 for e in ev if e.get("pid") == 1 and e.get("ph") == "X") \
        == len(rows)
    torch.cuda.reset_peak_memory_stats()
    b = torch.empty(1 << 20, device=cuda)
    assert paddle.device.cuda.max_memory_allocated() == \
        torch.cuda.max_memory_allocated()
    assert paddle.device.cuda.memory_allocated() == \
        torch.cuda.memory_allocated()
    del b
    paddle.device.cuda.reset_peak_memory_stats()
    assert paddle.device.cuda.max_memory_allocated() == \
        torch.cuda.max_memory_allocated()


def test_the_auditor_names_raw_torch_syncs_on_the_card(cuda):
    """A raw torch read (``.item()`` on a CUDA tensor) is a PTA001 at
    its line, from ``set_sync_debug_mode``'s warning; a Tensor read is
    counted once, by its hook."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import analysis
    a = torch.ones(4, device=cuda)
    t = paddle.Tensor(torch.ones(4, device=cuda))

    def step():
        x = (a * 2).sum().item()
        y = float(t.sum())
        return x + y
    rep = analysis.audit(step, warmup=1)
    sites = rep.sync_sites()
    seen = [(e["origin"], e["kind"], e.get("detail", "")[:60])
            for e in rep.syncs]
    assert len(rep.syncs) == 2, seen
    assert all(s.startswith("tests/test_torch_cuda.py:") for s in sites)
    kinds = sorted(e["kind"] for e in rep.syncs)
    assert kinds == ["item", "torch"]
    assert torch.cuda.get_sync_debug_mode() == 0

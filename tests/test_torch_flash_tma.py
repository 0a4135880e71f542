"""The flash-attention wrappers' choice of design, on the CPU.

``takes_tma`` decides from the operands alone which calls the TMA /
wgmma kernels (``csrc/flash_attention_tma.cu``: bf16, head dim 64 or
128, dropout at head dim 64 only, segments without dropout, bases and
strides a TMA tensor map describes) take; everything else goes to the
first design. ``segment_windows`` gives each CTA of those kernels its
window of tiles: here it is held against a brute-force scan of the
allowed pairs. On the CPU the three wrappers take their plain versions
whatever the design would be, and count nothing. The kernels themselves
run in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
No JAX here.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import transformer as ttr
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

B, L, H, D = 2, 40, 3, 128


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).bfloat16()


def _three(make):
    return [make(seed=i) for i in range(3)]


def _strided_qkv(seed=0):
    """q, k, v as views of one [B, L, 3, H, D] projection."""
    return list(_bf16(B, L, 3, H, D, seed=seed).unbind(2))


def _varlen_views(seed=0):
    """q, k, v as ``flash_attn_varlen_qkvpacked`` takes them: strided
    views of one packed ``[total, 3, H, 64]`` tensor, with a batch of
    one in front (sequence stride 3 H 64)."""
    qkv = _bf16(B * L, 3, H, 64, seed=seed)
    return [qkv[:, i][None] for i in range(3)]


def _seg(n=L, batch=B):
    return torch.zeros(batch, n, dtype=torch.int32)


def _misaligned(seed=0, d=D):
    """A base two bytes past a 16-byte boundary."""
    flat = torch.empty(B * L * H * d + 1, dtype=torch.bfloat16)
    x = flat[1:].view(B, L, H, d)
    x.copy_(_bf16(B, L, H, d, seed=seed))
    return x


def _captured(module, name, monkeypatch, call):
    """The q, k, v a model's attention hands its flash entry
    (``module.name``), captured on the CPU by a stand-in that returns
    zeros."""
    seen = []

    def grab(q, k, v, *args, **kwargs):
        seen.append((q, k, v))
        return torch.zeros_like(q)

    monkeypatch.setattr(module, name, grab)
    with torch.no_grad():
        call()
    return list(seen[0])


def _bert_views(monkeypatch):
    """MultiHeadAttention at BERT-base widths (hidden 768, 12 heads of
    64): separate q, k, v projections viewed as [B, L, 12, 64]."""
    mha = ttr.MultiHeadAttention(768, 12, dropout=0.1, dtype=torch.bfloat16)
    x = _bf16(B, L, 768)
    return _captured(tattn, "_flash", monkeypatch, lambda: mha(x))


def _gpt_views(monkeypatch):
    """GPTAttention at ERNIE-MoE widths (hidden 768, 12 heads of 64):
    one qkv projection split into three views of row stride 2304, k and
    v starting 1536 and 3072 bytes in."""
    attn = tgpt.GPTAttention(tgpt.GPTConfig(hidden_size=768,
                                            num_attention_heads=12,
                                            use_flash_attention=True),
                             device="cpu", dtype=torch.bfloat16)
    x = _bf16(B, L, 768)
    return _captured(tgpt, "flash_attention", monkeypatch, lambda: attn(x))


ACCEPTED = {
    "blhd": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)), {}),
    "bhld_3d": (lambda: _three(lambda seed: _bf16(B * H, L, D, seed=seed)),
                {}),
    "strided_qkv": (lambda: _strided_qkv(), {}),
    "heads_outer": (lambda: _three(
        lambda seed: _bf16(B, H, L, D, seed=seed).transpose(1, 2)), {}),
    "one_row": (lambda: _three(lambda seed: _bf16(B, 1, H, D, seed=seed)),
                {}),
    # head dim 64 (BERT-base, ERNIE-MoE), with dropout and without
    "d64": (lambda: _three(lambda seed: _bf16(B, L, H, 64, seed=seed)), {}),
    "d64_dropout": (lambda: _three(lambda seed: _bf16(B, L, H, 64,
                                                      seed=seed)),
                    {"dropout_p": 0.1}),
    "d64_bhld_3d": (lambda: _three(lambda seed: _bf16(B * H, L, 64,
                                                      seed=seed)), {}),
    "d64_bhld_3d_dropout": (lambda: _three(
        lambda seed: _bf16(B * H, L, 64, seed=seed)), {"dropout_p": 0.1}),
    "d64_one_row_dropout": (lambda: _three(
        lambda seed: _bf16(B, 1, H, 64, seed=seed)), {"dropout_p": 0.1}),
    # segments (varlen packing) without dropout, at both head dims, and
    # the varlen entry's strided views of its packed qkv
    "d64_segments": (lambda: _three(lambda seed: _bf16(B, L, H, 64,
                                                       seed=seed)),
                     {"seg": _seg()}),
    "segments": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
                 {"seg": _seg()}),
    "varlen_qkvpacked": (_varlen_views, {"seg": _seg(B * L, 1)}),
    # keys longer or shorter than the queries: cross-attention, a KV-cache
    # step, a chunk against its history
    "cross_lengths": (lambda: [_bf16(B, L, H, D), _bf16(B, 2 * L, H, D),
                               _bf16(B, 2 * L, H, D)], {}),
    "d64_cache_step_dropout": (lambda: [_bf16(B, 1, H, 64),
                                        _bf16(B, L + 3, H, 64),
                                        _bf16(B, L + 3, H, 64)],
                               {"dropout_p": 0.1}),
    "d64_more_queries": (lambda: [_bf16(B, L + 5, H, 64), _bf16(B, 7, H, 64),
                                  _bf16(B, 7, H, 64)], {}),
}

# the views the models build, captured with pytest's monkeypatch
MODEL_VIEWS = {"bert_mha": _bert_views, "ernie_moe_gpt": _gpt_views}

REFUSED = {
    "f32": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed).float()),
            {}),
    "dropout": (lambda: _three(lambda seed: _bf16(B, L, H, D, seed=seed)),
                {"dropout_p": 0.1}),
    "d32": (lambda: _three(lambda seed: _bf16(B, L, H, 32, seed=seed)), {}),
    "d64_f32_dropout": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed).float()),
        {"dropout_p": 0.1}),
    # segments with dropout (no instance: no public entry combines them),
    # in f32, or with ids the kernels cannot read in place
    "d64_segments_dropout": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed)),
        {"seg": _seg(), "dropout_p": 0.1}),
    "d64_segments_f32": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed).float()),
        {"seg": _seg()}),
    "d64_segments_int64": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed)),
        {"seg": _seg().long()}),
    "d64_segments_strided_rows": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed)),
        {"seg": torch.zeros(B, 2 * L, dtype=torch.int32)[:, ::2]}),
    "d64_segments_other_length": (lambda: _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed)), {"seg": _seg(L + 1)}),
    "d64_misaligned_base": (lambda: [_misaligned(0, 64)] + _three(
        lambda seed: _bf16(B, L, H, 64, seed=seed))[1:], {}),
    "d64_stride_not_16_bytes": (lambda: _three(
        lambda seed: _bf16(B, L, H, 68, seed=seed)[..., :64]), {}),
    "head_dim_not_contiguous": (lambda: _three(
        lambda seed: _bf16(B, L, H, 2 * D, seed=seed)[..., ::2]), {}),
    "misaligned_base": (lambda: [_misaligned(0)] + _three(
        lambda seed: _bf16(B, L, H, D, seed=seed))[1:], {}),
    "stride_not_16_bytes": (lambda: _three(
        lambda seed: _bf16(B, L, H, D + 4, seed=seed)[..., :D]), {}),
    # k and v of two lengths (q may differ from them in L alone)
    "shapes_differ": (lambda: [_bf16(B, L, H, D), _bf16(B, L + 1, H, D),
                               _bf16(B, L + 2, H, D)], {}),
    "heads_differ": (lambda: [_bf16(B, L, H, D), _bf16(B, L, 2 * H, D),
                              _bf16(B, L, 2 * H, D)], {}),
    "segments_cross_lengths": (lambda: [_bf16(B, L, H, D),
                                        _bf16(B, L + 64, H, D),
                                        _bf16(B, L + 64, H, D)],
                               {"seg": _seg()}),
    "empty": (lambda: _three(lambda seed: _bf16(B, 0, H, D, seed=seed)), {}),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_takes_tma_accepts_what_a_tensor_map_describes(name):
    make, kw = ACCEPTED[name]
    q, k, v = make()
    assert tfa.takes_tma(q, k, v, **kw) is True
    # the backward's call: dO beside them
    assert tfa.takes_tma(q, k, v, torch.zeros_like(q), **kw) is True


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("model", sorted(MODEL_VIEWS))
def test_takes_tma_accepts_the_views_the_models_build(model, dropout_p,
                                                      monkeypatch):
    """The exact q, k, v of BERT-base's MultiHeadAttention and ERNIE-MoE's
    GPTAttention go to the TMA kernels, with dropout and without."""
    q, k, v = MODEL_VIEWS[model](monkeypatch)
    assert q.shape == (B, L, 12, 64) and q.dtype == torch.bfloat16
    if model == "ernie_moe_gpt":       # views of one [B, L, 2304] output
        assert q.stride() == (L * 2304, 2304, 64, 1)
        assert k.data_ptr() - q.data_ptr() == 1536
        assert v.data_ptr() - q.data_ptr() == 3072
    do = torch.zeros_like(q)
    assert tfa.takes_tma(q, k, v, do, dropout_p=dropout_p) is True


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_takes_tma_refuses_what_the_first_design_keeps(name):
    make, kw = REFUSED[name]
    q, k, v = make()
    assert tfa.takes_tma(q, k, v, **kw) is False


@pytest.mark.parametrize("which", ["misaligned", "f32", "other_shape"])
def test_takes_tma_checks_the_backward_dout(which):
    """The backward's dO must meet the same conditions as q, k, v."""
    q, k, v = ACCEPTED["blhd"][0]()
    do = {"misaligned": _misaligned,
          "f32": lambda: torch.zeros(B, L, H, D),
          "other_shape": lambda: torch.zeros(B, L + 1, H, D,
                                             dtype=torch.bfloat16)}[which]()
    assert tfa.takes_tma(q, k, v) is True
    assert tfa.takes_tma(q, k, v, do) is False


@pytest.mark.parametrize("layout", ["blhd", "strided_qkv", "d64",
                                    "d64_dropout", "d64_segments",
                                    "varlen_qkvpacked"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(layout,
                                                               causal):
    """Calls the TMA kernels would take on the card run the plain versions
    here, bit for bit, and no count moves."""
    make, drop = ACCEPTED[layout]
    q, k, v = make()
    kw = dict(drop, seed=0x5EED) if drop else {}
    if "seg" in drop:              # two segments of the rows
        kw["seg"] = drop["seg"].clone()
        kw["seg"][:, q.shape[1] // 3:] = 1
    do = _bf16(*q.shape, seed=9)
    assert tfa.takes_tma(q, k, v, do, **drop)
    ws = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
          tfa.flash_attention_bwd_dkv)
    counts = ("launches", "tma_launches", "dropout_launches",
              "segmented_launches")
    before = [[getattr(w, c) for c in counts] for w in ws]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, **kw)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         **kw)
    assert [[getattr(w, c) for c in counts] for w in ws] == before
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                         **kw)
    ref_dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal, **kw)
    ref_dk, ref_dv = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal, **kw)
    for got, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                     (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the TMA kernels' windows of tiles
# ---------------------------------------------------------------------------

def _ids(kind):
    """[2, L] int32 segment ids of one kind: packed sequences (sorted;
    lengths from 1 up, L not a multiple of 32), random ids (unsorted),
    one segment, and sequences that end one row into a block."""
    rng = np.random.default_rng({"sorted": 1, "unsorted": 2, "single": 3,
                                 "edges": 4}[kind])
    if kind == "unsorted":
        return torch.from_numpy(rng.integers(0, 4, (2, 300))
                                .astype(np.int32))
    if kind == "single":
        return torch.zeros(2, 77, dtype=torch.int32)
    lens = ([[1, 160, 37, 64, 5, 33], [129, 1, 63, 65, 42]]
            if kind == "edges" else
            [list(rng.integers(1, 120, 5)) for _ in range(2)])
    n = max(sum(x) for x in lens)
    rows = []
    for x in lens:
        x = list(x) + [n - sum(x)] if sum(x) < n else list(x)
        rows.append(np.repeat(np.arange(len(x)), x))
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def _brute_windows(seg, block, tile, causal, rows_are_keys):
    """Per block, the tiles holding an allowed pair, from every pair:
    ``[B, blocks]`` lists."""
    batch, n = seg.shape
    out = []
    for b in range(batch):
        s = seg[b]
        same = s[:, None] == s[None, :]          # [row, column]
        if causal:
            r = torch.arange(n)
            same &= (r[None, :] >= r[:, None]) if rows_are_keys \
                else (r[None, :] <= r[:, None])
        out.append([sorted({int(c) // tile for c in
                            same[i:i + block].nonzero()[:, 1]})
                    for i in range(0, n, block)])
    return out


# (rows a block owns, rows of a tile, whether the block's rows are keys):
# every size the windows are built at is a multiple of 32, and the TMA
# kernels' (which the library reports, tests/test_torch_cuda.py) are among
# these
WINDOW_GEOMETRIES = [(block, tile, keys) for block in (64, 128)
                     for tile in (32, 64, 128) for keys in (False, True)]


@pytest.mark.parametrize(
    "geometry", WINDOW_GEOMETRIES,
    ids=lambda x: f"{'keys' if x[2] else 'queries'}{x[0]}_over{x[1]}")
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "single", "edges"])
def test_segment_windows_hold_every_allowed_pair(kind, causal, geometry):
    """Every tile holding an allowed pair of a block lies inside the
    block's window, in both directions (query blocks over key tiles,
    key blocks over query stages) and for any ids; for sorted ids the
    window is exact: it starts and ends on such tiles."""
    seg = _ids(kind)
    block, tile, keys = geometry
    win = tfa.segment_windows(tfa._seg_ranges(seg), block, tile, causal,
                              keys)
    want = _brute_windows(seg, block, tile, causal, keys)
    n = seg.shape[1]
    assert win.dtype == torch.int32 and win.is_contiguous()
    assert tuple(win.shape) == (seg.shape[0], -(-n // block), 2)
    for b, blocks in enumerate(want):
        for i, tiles in enumerate(blocks):
            lo, hi = (int(x) for x in win[b, i])
            assert tiles, "a block's rows always pair with themselves"
            assert lo <= tiles[0] and tiles[-1] < hi <= -(-n // tile)
            if kind != "unsorted":
                assert (lo, hi) == (tiles[0], tiles[-1] + 1)


def test_segment_plan_builds_each_window_once(monkeypatch):
    """A plan builds its chunk ranges once and each window at its first
    use, at the tiles the library reports (here a stand-in for it): two
    kernels of one tile geometry share a window (the D-64 forward and
    dQ, 128-row blocks over 64-key tiles), dK/dV and causal calls have
    their own."""
    tiles = {("fwd", 64): (128, 64), ("dq", 64): (128, 64),
             ("dkv", 64): (128, 32), ("fwd", 128): (128, 128)}
    monkeypatch.setattr(tfa, "_tma_tiles", lambda kernel, d: tiles[kernel, d])
    seg = _ids("sorted")
    plan = tfa.SegmentPlan(seg)
    assert torch.equal(plan.ranges, tfa._seg_ranges(seg))
    fwd = plan.window("fwd", 64, False)
    assert plan.window("dq", 64, False) is fwd
    assert plan.window("fwd", 64, False) is fwd
    assert plan.window("fwd", 64, True) is not fwd
    assert plan.window("dkv", 64, False).shape == fwd.shape
    assert plan.window("fwd", 128, False) is not fwd
    # a wrapper takes the plan or the ids alike
    q, k, v = _three(lambda seed: _bf16(2, seg.shape[1], 1, 64, seed=seed))
    assert tfa.takes_tma(q, k, v, seg=plan) and tfa.takes_tma(q, k, v,
                                                             seg=seg)
    a, la = tfa.flash_attention_fwd(q, k, v, True, seg=plan)
    b, lb = tfa.flash_attention_fwd(q, k, v, True, seg=seg)
    assert torch.equal(a, b) and torch.equal(la, lb)

"""The split paged-attention design's plain version and its selection.

``paged_attention_split_reference`` walks each span of history columns
on its own and merges the spans by the kernel's log-sum-exp rule; here
it is held against the JAX package's jnp walk and its Pallas kernel
(interpreted on the CPU), and against the port's own walk, over the
paged-attention tests' geometries and the cases a split walk can get
wrong: spans past every row's position, ``n_tiles`` cutting a span, one
live span beside many, rows with no live column, poisoned blocks. The
Hopper kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: f32 and int8 pools, rtol = atol = 1e-5 (the same
online-softmax recurrence, merged in another order); bf16, 2e-2 abs +
rel (the walks round tiles and probabilities to bf16 at the same places,
and the merge reorders f32 sums of those bf16 products)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpk
from paddle_tpu.serving_cache import absmax_quantize as jax_absmax
from paddle_tpu.serving_cache import paged_attention as jax_walk
from paddle_tpu_torch.ops.kernels import paged_attention as tpk

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2e-2

# (S, T, H, KVH, D, block_size, max_blocks), as in
# tests/test_torch_paged_attention.py
GEOMETRIES = [
    (2, 1, 4, 2, 8, 8, 4),
    (3, 5, 4, 2, 8, 8, 4),
    (2, 4, 4, 4, 16, 4, 6),
    (1, 8, 2, 1, 8, 16, 2),
    (2, 3, 8, 2, 8, 4, 5),
]


def _ids(g):
    return "x".join(map(str, g))


def _case(S, T, H, K, D, bs, MB, quant, seed, last=None, poison=False):
    """Seeded numpy inputs. ``last`` [S] fixes each slot's last position
    (row t of slot s at last[s] - T + 1 + t); ``poison`` leaves block 0
    to nobody, unmaps every tile past a slot's last one (they clamp to
    block 0) and fills block 0 with NaN/inf (int8: its scales)."""
    rng = np.random.default_rng(seed)
    NB = S * MB + 2
    q = rng.standard_normal((S, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, D)).astype(np.float32)
    first = 1 if poison else 0
    tables = (first + rng.permutation(NB - first)[:S * MB]).reshape(S, MB)
    if last is None:
        last = rng.integers(T - 1, bs * MB, S)
    pos = (np.asarray(last)[:, None] - (T - 1)
           + np.arange(T)[None, :]).astype(np.int32)
    if poison:
        for s in range(S):
            tables[s, int(pos[s].max()) // bs + 1:] = -1
        kp[0] = np.nan
        vp[0] = np.inf
    kw = dict(block_size=bs, n_rep=H // K)
    scales = {}
    if quant:
        kq, ks = jax_absmax(jnp.asarray(np.nan_to_num(kp).reshape(-1, K, D)))
        vq, vs = jax_absmax(jnp.asarray(np.nan_to_num(vp).reshape(-1, K, D)))
        kp = np.array(kq).reshape(NB, bs, K, D)
        vp = np.array(vq).reshape(NB, bs, K, D)
        scales = dict(k_scale=np.array(ks).reshape(NB, bs, K),
                      v_scale=np.array(vs).reshape(NB, bs, K))
        if poison:
            scales["k_scale"][0] = np.nan
            scales["v_scale"][0] = np.inf
    return (q, kp, vp, tables.astype(np.int32), pos), kw, scales


def _jax(args, kw, scales, **extra):
    walk = jax.jit(functools.partial(jax_walk, use_kernel=False, **kw,
                                     **extra))
    return np.asarray(walk(
        *(jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in scales.items()}))


def _torch(fn, args, kw, scales, dtype=torch.float32, **extra):
    q, kp, vp, tables, pos = (torch.from_numpy(a) for a in args)
    if dtype != torch.float32:
        q = q.to(dtype)
        if kp.dtype == torch.float32:
            kp, vp = kp.to(dtype), vp.to(dtype)
    return fn(q, kp, vp, tables, pos, **kw, **extra,
              **{k: torch.from_numpy(v) for k, v in scales.items()}
              ).float().numpy()


def _split(args, kw, scales, span, **extra):
    return _torch(tpk.paged_attention_split_reference, args, kw, scales,
                  span=span, **extra)


@pytest.mark.parametrize("span_tiles", [1, 2, 1.5], ids=["span=bs",
                                                        "span=2bs",
                                                        "span=1.5bs"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=_ids)
def test_split_reference_matches_jax_walk(geo, quant, span_tiles):
    """Spans of one, two and one and a half tiles (a span boundary inside
    a tile) merge to the JAX walk's output."""
    args, kw, scales = _case(*geo, quant=quant, seed=sum(geo))
    span = max(1, int(geo[5] * span_tiles))
    np.testing.assert_allclose(_split(args, kw, scales, span),
                               _jax(args, kw, scales), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geo", GEOMETRIES[:4], ids=_ids)
def test_split_reference_matches_pallas_kernel_interpreted(geo, quant):
    if not jpk._HAS_PALLAS:
        pytest.skip("Pallas unavailable: the jnp walk is the only JAX "
                    "path here")
    args, kw, scales = _case(*geo, quant=quant, seed=sum(geo) + 1)
    want = np.asarray(jpk.paged_attention_kernel(
        *(jnp.asarray(a) for a in args), interpret=True, **kw,
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    np.testing.assert_allclose(_split(args, kw, scales, geo[5]), want,
                               **TOL)


@pytest.mark.parametrize("span", [64, 96, 1000], ids=lambda s: f"span{s}")
def test_spans_past_every_rows_position(span):
    """The histories end early in the table: every span past them holds
    no live column (and a span longer than the whole table is one
    span)."""
    args, kw, scales = _case(2, 3, 4, 2, 8, 8, 16, quant=False, seed=4,
                             last=[20, 9])
    np.testing.assert_allclose(_split(args, kw, scales, span),
                               _jax(args, kw, scales), **TOL)


@pytest.mark.parametrize("n_tiles", [3, 5, 9], ids=lambda n: f"n{n}")
def test_n_tiles_cutting_a_span(n_tiles):
    """Spans of four tiles; n_tiles ends the walk inside a span."""
    args, kw, scales = _case(2, 2, 4, 2, 8, 8, 12, quant=True, seed=5,
                             last=[95, 60])
    want = _jax(args, kw, scales, n_tiles=n_tiles)
    np.testing.assert_allclose(
        _split(args, kw, scales, 32, n_tiles=n_tiles), want, **TOL)
    got_t = _split(args, kw, scales, 32,
                   n_tiles=torch.tensor([n_tiles], dtype=torch.int32))
    np.testing.assert_allclose(got_t, want, **TOL)


def test_one_live_span_beside_many():
    """Slot 0 spans eight spans, slot 1 lives in the first alone."""
    args, kw, scales = _case(2, 1, 4, 4, 16, 4, 32, quant=False, seed=6,
                             last=[127, 5])
    np.testing.assert_allclose(_split(args, kw, scales, 16),
                               _jax(args, kw, scales), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_rows_with_no_live_column_give_zero(quant):
    """n_tiles = 0 leaves no live column: every row is exactly 0, as in
    the JAX walk."""
    args, kw, scales = _case(2, 3, 4, 2, 8, 8, 4, quant=quant, seed=7)
    got = _split(args, kw, scales, 8, n_tiles=0)
    np.testing.assert_array_equal(got, np.zeros_like(got))
    np.testing.assert_array_equal(_jax(args, kw, scales, n_tiles=0), got)


@pytest.mark.parametrize("span", [8, 16], ids=lambda s: f"span{s}")
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_poisoned_blocks_are_masked_to_exactly_zero(quant, span):
    """Block 0 holds NaN/inf values (bf16 pools) or NaN/inf scales (int8)
    and backs every unmapped tile past the histories: the split walk in
    bf16 stays finite and agrees with the walk and with the JAX walk on
    the same bf16 inputs."""
    args, kw, scales = _case(3, 2, 4, 2, 16, 8, 6, quant=quant, seed=8,
                             last=[30, 17, 4], poison=True)
    got = _torch(tpk.paged_attention_split_reference, args, kw, scales,
                 dtype=torch.bfloat16, span=span)
    assert np.isfinite(got).all()
    walk = _torch(tpk.paged_attention_reference, args, kw, scales,
                  dtype=torch.bfloat16)
    np.testing.assert_allclose(got, walk, rtol=BF16_TOL, atol=BF16_TOL)
    q, kp, vp, tables, pos = args
    jargs = [jnp.asarray(q, jnp.bfloat16)]
    jargs += [jnp.asarray(a) if quant else jnp.asarray(a, jnp.bfloat16)
              for a in (kp, vp)]
    jargs += [jnp.asarray(tables), jnp.asarray(pos)]
    want = np.asarray(jax.jit(functools.partial(
        jax_walk, use_kernel=False, **kw))(
            *jargs, **{k: jnp.asarray(v) for k, v in scales.items()})
    ).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("q_dtype,pool_dtype,D,bs,mb,expect", [
    (torch.bfloat16, torch.bfloat16, 128, 16, 128, True),
    (torch.bfloat16, torch.bfloat16, 64, 16, 32, True),
    (torch.bfloat16, torch.int8, 128, 16, 64, True),
    (torch.bfloat16, torch.int8, 64, 32, 16, True),
    (torch.bfloat16, torch.bfloat16, 128, 128, 16, True),
    (torch.bfloat16, torch.bfloat16, 128, 48, 8, True),
    (torch.bfloat16, torch.bfloat16, 128, 16, 8192, True),
    (torch.bfloat16, torch.bfloat16, 128, 16, 8193, False),
    (torch.float32, torch.float32, 128, 16, 32, False),
    (torch.float32, torch.int8, 64, 16, 16, False),
    (torch.bfloat16, torch.float32, 128, 16, 32, False),
    (torch.bfloat16, torch.bfloat16, 96, 16, 32, False),
    (torch.bfloat16, torch.bfloat16, 128, 8, 32, False),
    (torch.bfloat16, torch.bfloat16, 128, 24, 32, False),
    (torch.bfloat16, torch.bfloat16, 128, 144, 8, False),
], ids=["bf16-d128-bs16", "bf16-d64", "int8-d128", "int8-d64-bs32",
        "bf16-bs128", "bf16-bs48", "bf16-64-spans", "bf16-65-spans",
        "f32", "f32-q-int8", "f32-pools", "d96", "bs8", "bs24", "bs144"])
def test_takes_split_decides_from_dtypes_and_shapes(q_dtype, pool_dtype, D,
                                                    bs, mb, expect):
    """bf16 q over bf16 or int8 pools, head dim 64 or 128, block sizes
    that are multiples of 16 up to 128 and at most 64 spans of 2048
    columns take the split design; every other call the first design."""
    q = torch.empty((2, 1, 4, D), dtype=q_dtype, device="meta")
    pool = torch.empty((9, bs, 2, D), dtype=pool_dtype, device="meta")
    tables = torch.empty((2, mb), dtype=torch.int32, device="meta")
    assert tpk.takes_split(q, pool, tables) is expect


@pytest.mark.parametrize("args,expect", [
    # (T, n_rep, S, KVH, D, bs, MB, sms) -> (group rows, units, span,
    # spans): MHA decode; a 2-row verify window; GQA at R = 4; the
    # 64-row prefill chunk (span halved: 256 CTAs < 4 an SM); a dense
    # 512-row prefill (the partial states cap the span at 1024); a GQA
    # verify window over a long table (span halved)
    ((1, 1, 8, 32, 128, 16, 128, 132), (1, 256, 256, 8)),
    ((2, 1, 8, 32, 128, 16, 128, 132), (4, 256, 256, 8)),
    ((1, 4, 8, 8, 128, 16, 128, 132), (64, 64, 256, 8)),
    ((64, 1, 1, 32, 128, 16, 128, 132), (64, 32, 128, 16)),
    ((512, 1, 1, 32, 128, 128, 16, 132), (64, 256, 1024, 2)),
    ((3, 4, 2, 8, 128, 16, 256, 132), (64, 16, 128, 32)),
])
def test_split_plan(args, expect):
    assert tpk.split_plan(*args) == expect


def test_split_plan_grows_the_span_for_long_tables():
    """More than 64 spans of 256 columns: the span doubles until 64
    spans cover the table."""
    g, units, span, n = tpk.split_plan(1, 1, 1, 8, 128, 16, 4096)
    assert (g, units) == (1, 8)
    assert span == 1024 and n == 64


def test_cpu_wrapper_takes_the_walk_and_counts_no_split_launch():
    """On the CPU a call the split design would take runs the plain walk
    and counts nothing."""
    args, kw, scales = _case(2, 1, 4, 2, 64, 16, 4, quant=False, seed=9)
    w = tpk.paged_attention_kernel
    before = (w.launches, w.split_launches, w.mma_launches)
    got = _torch(w, args, kw, scales, dtype=torch.bfloat16)
    want = _torch(tpk.paged_attention_reference, args, kw, scales,
                  dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    assert (w.launches, w.split_launches, w.mma_launches) == before

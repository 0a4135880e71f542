"""Paged attention: the port's plain walk against the JAX package's jnp
walk and its Pallas kernel (interpreted on the CPU), and the seam's
routing. The Hopper kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: f32, rtol = atol = 1e-5 — the walks compute the same
online-softmax recurrence, and sums run in a different order."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpk
from paddle_tpu.serving_cache import absmax_quantize as jax_absmax
from paddle_tpu.serving_cache import paged_attention as jax_walk
from paddle_tpu_torch import serving_cache as tsc
from paddle_tpu_torch.ops.kernels import paged_attention as tpk

TOL = dict(rtol=1e-5, atol=1e-5)

# (S, T, H, KVH, D, block_size, max_blocks): the four geometries of the
# JAX package's own kernel-seam test (n_rep R = 2, 2, 1, 2), then R = 4
GEOMETRIES = [
    (2, 1, 4, 2, 8, 8, 4),
    (3, 5, 4, 2, 8, 8, 4),
    (2, 4, 4, 4, 16, 4, 6),
    (1, 8, 2, 1, 8, 16, 2),
    (2, 3, 8, 2, 8, 4, 5),
]


def _case(S, T, H, K, D, bs, MB, quant, seed, poison=False):
    rng = np.random.default_rng(seed)
    NB = S * MB + 2
    q = rng.standard_normal((S, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, D)).astype(np.float32)
    if poison:
        # block 0 is nobody's block; every slot's last tile is unmapped
        # (-1 clamps to the NaN/inf block 0) and positions stop short
        tables = 1 + rng.permutation(NB - 1)[:S * MB].reshape(S, MB)
        tables[:, MB - 1] = -1
        hi = bs * (MB - 1) - T
        kp[0] = np.nan
        vp[0] = np.inf
    else:
        tables = rng.permutation(NB)[:S * MB].reshape(S, MB)
        tables[0, MB - 1] = -1               # unmapped tail
        hi = bs * MB - T
    pos = (rng.integers(0, hi, (S, 1))
           + np.arange(T)[None, :]).astype(np.int32)
    kw = dict(block_size=bs, n_rep=H // K)
    scales = {}
    if quant:
        kq, ks = jax_absmax(jnp.asarray(kp.reshape(NB * bs, K, D)))
        vq, vs = jax_absmax(jnp.asarray(vp.reshape(NB * bs, K, D)))
        kp = np.array(kq).reshape(NB, bs, K, D)
        vp = np.array(vq).reshape(NB, bs, K, D)
        scales = dict(k_scale=np.array(ks).reshape(NB, bs, K),
                      v_scale=np.array(vs).reshape(NB, bs, K))
    return (q, kp, vp, tables.astype(np.int32), pos), kw, scales


def _jax(args, kw, scales, **extra):
    walk = jax.jit(functools.partial(jax_walk, use_kernel=False, **kw,
                                     **extra))
    return np.asarray(walk(
        *(jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in scales.items()}))


def _torch(fn, args, kw, scales, **extra):
    return fn(*(torch.from_numpy(a) for a in args), **kw,
              **{k: torch.from_numpy(v) for k, v in scales.items()},
              **extra).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "x".join(
    map(str, g)))
def test_reference_matches_jax_walk(geo, quant):
    args, kw, scales = _case(*geo, quant=quant, seed=sum(geo))
    want = _jax(args, kw, scales)
    got = _torch(tpk.paged_attention_reference, args, kw, scales)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geo", GEOMETRIES[:4], ids=lambda g: "x".join(
    map(str, g)))
def test_reference_matches_pallas_kernel_interpreted(geo, quant):
    if not jpk._HAS_PALLAS:
        pytest.skip("Pallas unavailable: the jnp walk is the only JAX "
                    "path here")
    args, kw, scales = _case(*geo, quant=quant, seed=sum(geo))
    want = np.asarray(jpk.paged_attention_kernel(
        *(jnp.asarray(a) for a in args), interpret=True, **kw,
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    got = _torch(tpk.paged_attention_reference, args, kw, scales)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_n_tiles_bounds_the_walk(n_tiles):
    args, kw, scales = _case(2, 2, 4, 2, 8, 4, 5, quant=False, seed=3)
    want = _jax(args, kw, scales, n_tiles=n_tiles)
    got = _torch(tpk.paged_attention_reference, args, kw, scales,
                 n_tiles=n_tiles)
    np.testing.assert_allclose(got, want, **TOL)
    got_t = _torch(tpk.paged_attention_reference, args, kw, scales,
                   n_tiles=torch.tensor([n_tiles], dtype=torch.int32))
    np.testing.assert_array_equal(got_t, got)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_recycled_garbage_is_masked_to_exactly_zero(quant):
    """An unmapped entry clamps to block 0; with block 0 full of NaN/inf
    and every position short of it, the output is finite and equal to
    the JAX walk's and the Pallas kernel's."""
    args, kw, scales = _case(2, 1, 4, 2, 8, 8, 4, quant=quant, seed=9,
                             poison=True)
    if quant:
        scales["k_scale"][0] = np.nan
        scales["v_scale"][0] = np.inf
    got = _torch(tpk.paged_attention_reference, args, kw, scales)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(args, kw, scales), **TOL)
    if jpk._HAS_PALLAS:
        pallas = np.asarray(jpk.paged_attention_kernel(
            *(jnp.asarray(a) for a in args), interpret=True, **kw,
            **{k: jnp.asarray(v) for k, v in scales.items()}))
        np.testing.assert_allclose(got, pallas, **TOL)


def test_gqa_head_order_is_kvh_major():
    """Query head h attends KV head h // n_rep (not h % KVH): zeroing KV
    head 1 must change exactly the query heads 2 and 3 (n_rep 2)."""
    args, kw, scales = _case(1, 1, 4, 2, 8, 8, 2, quant=False, seed=5)
    base = _torch(tpk.paged_attention_reference, args, kw, scales)
    q, kp, vp, tables, pos = args
    vp = vp.copy()
    vp[:, :, 1] = 0.0
    got = _torch(tpk.paged_attention_reference,
                 (q, kp, vp, tables, pos), kw, scales)
    np.testing.assert_array_equal(got[:, :, :2], base[:, :, :2])
    assert np.abs(got[:, :, 2:]).max() == 0.0


def test_cpu_seam_takes_the_walk_and_counts_no_launch():
    args, kw, scales = _case(2, 3, 4, 2, 8, 4, 5, quant=True, seed=11)
    before = tpk.paged_attention_kernel.launches
    want = _torch(tpk.paged_attention_reference, args, kw, scales)
    for use_kernel in (None, True, False):
        got = _torch(tsc.paged_attention, args, kw, scales,
                     use_kernel=use_kernel)
        np.testing.assert_array_equal(got, want)
    got = _torch(tpk.paged_attention_kernel, args, kw, scales)
    np.testing.assert_array_equal(got, want)
    assert tpk.paged_attention_kernel.launches == before == 0


def test_wrapper_refuses_a_device_it_cannot_run_on():
    q = torch.zeros((1, 1, 2, 64), device="meta")
    pool = torch.zeros((2, 4, 2, 64), device="meta")
    tab = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpk.paged_attention_kernel(q, pool, pool, tab, pos, block_size=4,
                                   n_rep=1)
    assert tpk.paged_attention_kernel.launches == 0


def test_wrapper_checks_shapes_and_dtypes_before_launch():
    """The argument checks run before any build or launch (here on
    tensors that merely claim their shapes): a head dim, dtype or
    scale mismatch is a ValueError."""
    def call(**over):
        t = dict(q=torch.zeros((1, 1, 2, 64)),
                 k=torch.zeros((2, 4, 2, 64)),
                 v=torch.zeros((2, 4, 2, 64)),
                 tab=torch.zeros((1, 2), dtype=torch.int32),
                 pos=torch.zeros((1, 1), dtype=torch.int32),
                 ks=None, vs=None, bs=4, rep=1)
        t.update(over)
        tpk._check(t["q"], t["k"], t["v"], t["tab"], t["pos"], t["ks"],
                   t["vs"], t["bs"], t["rep"])

    call()
    for over, msg in [
            (dict(q=torch.zeros((1, 1, 2, 96))), "head dim"),
            (dict(q=torch.zeros((1, 1, 2, 64), dtype=torch.float16)),
             "q dtype"),
            (dict(bs=8), "block_size"),
            (dict(rep=2), "n_rep"),
            (dict(tab=torch.zeros((1, 2), dtype=torch.int64)), "tables"),
            (dict(pos=torch.zeros((1, 2), dtype=torch.int32)),
             "positions"),
            (dict(k=torch.zeros((2, 4, 2, 64), dtype=torch.int8),
                  v=torch.zeros((2, 4, 2, 64), dtype=torch.int8)),
             "int8 pools need"),
            (dict(ks=torch.zeros((2, 4, 2)), vs=torch.zeros((2, 4, 2))),
             "int8 pools need"),
            (dict(q=torch.zeros((1, 1, 2, 64)).transpose(2, 3)
                  .contiguous().transpose(2, 3)), "contiguous")]:
        with pytest.raises(ValueError, match=msg):
            call(**over)


def test_absmax_quantize_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((40, 3, 16)) * 5).astype(np.float32)
    x[3] = 0.0                                   # all-zero rows: 1e-8
    jc, js = jax_absmax(jnp.asarray(x))
    tc, ts = tsc.absmax_quantize(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

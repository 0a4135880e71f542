"""PagedKVCache parity: one scripted sequence of allocator operations on
the JAX package's cache and on the port's, with identical return
values, block tables and stats at every step and the invariants
checked after each; plus the device-side block writes."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving_cache import PagedKVCache as JaxCache
from paddle_tpu.serving_cache import write_kv_tokens as jax_write
from paddle_tpu_torch import serving_cache as tsc

BS = 4


def _script(cls):
    """Drive one cache through admission (with and without token ids),
    prefix commit + dedupe, block-aligned COW, the write-time COW guard,
    extension, truncate, release (evicted and not) and LRU eviction
    under a small pool. Returns the per-step trace."""
    kv = cls(max_slots=4, max_seq=80, block_size=BS, num_blocks=16,
             prefix_cache=True, prefix_cache_blocks=0)
    trace = []

    def do(tag, fn, *args, **kw):
        try:
            ret = fn(*args, **kw)
        except (ValueError, RuntimeError) as e:
            ret = ("raised", type(e).__name__)
        if isinstance(ret, tuple):
            ret = tuple(int(x) if isinstance(x, (int, np.integer)) else x
                        for x in ret)
        elif isinstance(ret, (np.integer, bool)):
            ret = int(ret)
        kv.check_invariants()
        trace.append((tag, ret, kv.block_tables.copy(), kv.stats(),
                      kv.available_blocks(), kv.used_blocks(),
                      kv.cached_blocks(), kv.occupied_slots()))

    A = list(range(1, 11))                  # 10 tokens: 2 full blocks
    do("admit0", kv.admit, 0, len(A), 18, token_ids=A)
    do("commit0", kv.commit_prefix, 0, A, 10)
    do("admit1-prefix", kv.admit, 1, 9, 14, token_ids=A[:8] + [99])
    do("matched1", kv.matched_tokens, 1)
    do("take_cow1-none", kv.take_cow, 1)
    do("admit2-no-ids", kv.admit, 2, 10, 16)
    do("commit2-dedupe", kv.commit_prefix, 2, A, 10)
    do("admit3-aligned", kv.admit, 3, 8, 12, token_ids=A[:8])
    do("matched3", kv.matched_tokens, 3)
    do("take_cow3", kv.take_cow, 3)
    do("ensure0", kv.ensure_token, 0, 10)
    do("ensure0-next", kv.ensure_token, 0, 12)
    do("ensure0-again", kv.ensure_token, 0, 13)
    do("cow_write1-mid", kv.cow_for_write, 1, 2)
    do("cow_write1-boundary", kv.cow_for_write, 1, 5)
    do("cow_write1-private", kv.cow_for_write, 1, 9)
    do("reserve_through1", kv.reserve_through, 1, 15)
    do("truncate1", kv.truncate, 1, 9)
    do("truncate2-into-shared", kv.truncate, 2, 4)
    do("release1", kv.release, 1)
    do("release2-evicted", kv.release, 2, evicted=True)
    do("admit1-too-big", kv.admit, 1, 30, 40, token_ids=list(range(30)))
    do("admit1-never", kv.admit, 1, 30, 200)
    do("release0", kv.release, 0)
    do("release3", kv.release, 3)
    do("admit-lru", kv.admit, 0, 30, 39, token_ids=list(range(50, 80)))
    do("admit-lru-2", kv.admit, 1, 12, 14, token_ids=A[:8] + [7, 7, 7, 7])
    do("release-all0", kv.release, 0)
    do("release-all1", kv.release, 1)
    # the whole pool: the free list runs dry and LRU reclaims the tree
    do("admit-evicts-lru", kv.admit, 2, 60, 64,
       token_ids=list(range(100, 160)))
    do("commit-full", kv.commit_prefix, 2, list(range(100, 160)), 60)
    do("release2-evicted", kv.release, 2, evicted=True)
    do("reset_prefix", kv.reset_prefix_cache)
    do("active_tokens", kv.active_tokens, np.array([3, 5, 7, 9]),
       np.array([True, False, True, False]))
    return trace


def test_scripted_sequence_matches_the_jax_cache():
    want, got = _script(JaxCache), _script(tsc.PagedKVCache)
    assert [t[0] for t in got] == [t[0] for t in want]
    for w, g in zip(want, got):
        tag = w[0]
        assert g[1] == w[1], (tag, g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2], err_msg=tag)
        for i in range(3, len(w)):
            assert g[i] == w[i], (tag, i, g[i], w[i])
    tags = {t[0]: t[1] for t in got}
    # the script reached the paths it is meant to cover
    assert tags["matched1"] == 8 and tags["matched3"] == 7
    assert tags["take_cow3"] is not None
    assert tags["cow_write1-mid"] == ("raised", "RuntimeError")
    assert tags["admit1-never"] == ("raised", "ValueError")
    lru = [t for t in got if t[0] == "admit-evicts-lru"][0]
    assert lru[1] == 1 and lru[3]["evictions"] >= 1


def test_prefix_cache_off_is_private_blocks_only():
    kv = tsc.PagedKVCache(max_slots=2, max_seq=32, block_size=BS,
                          num_blocks=8, prefix_cache=False)
    A = list(range(1, 9))
    assert kv.admit(0, 8, 8, token_ids=A)
    assert kv.commit_prefix(0, A, 8) == 0
    assert kv.admit(1, 8, 8, token_ids=A)
    assert kv.matched_tokens(1) == 0
    assert kv.stats()["blocks_cached"] == 0
    kv.check_invariants()


def test_write_kv_tokens_drops_out_of_range_rows():
    """Rows mapped to ``num_blocks`` (or any invalid block) are dropped
    in place; the JAX scatter with mode='drop' gives the same pool."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    NB, K, D = 5, 2, 4
    pool = rng.standard_normal((NB, BS, K, D)).astype(np.float32)
    vals = rng.standard_normal((6, K, D)).astype(np.float32)
    phys = np.array([0, NB, 3, 2, 4, NB + 7], np.int32)
    off = np.array([1, 2, 0, 3, 3, 1], np.int32)
    want = np.asarray(jax_write(jnp.asarray(pool), jnp.asarray(phys),
                                jnp.asarray(off), jnp.asarray(vals)))
    tpool = torch.from_numpy(pool.copy())
    out = tsc.write_kv_tokens(tpool, phys, off, torch.from_numpy(vals))
    assert out is tpool                      # in place
    np.testing.assert_array_equal(tpool.numpy(), want)
    # a host-side plan reused across layers writes the same rows
    plan = tsc.plan_kv_writes(phys, off, NB, torch.device("cpu"))
    assert plan.rows.tolist() == [0, 2, 3, 4]
    p2 = torch.from_numpy(pool.copy())
    tsc.scatter_kv(p2, plan, torch.from_numpy(vals))
    np.testing.assert_array_equal(p2.numpy(), tpool.numpy())
    # tensor indices on the host work the same
    p3 = torch.from_numpy(pool.copy())
    tsc.write_kv_tokens(p3, torch.from_numpy(phys), torch.from_numpy(off),
                        torch.from_numpy(vals))
    np.testing.assert_array_equal(p3.numpy(), tpool.numpy())
    # a negative block is dropped too (never wrapped around)
    p4 = torch.from_numpy(pool.copy())
    tsc.write_kv_tokens(p4, np.array([-1]), np.array([0]),
                        torch.from_numpy(vals[:1]))
    np.testing.assert_array_equal(p4.numpy(), pool)


def test_write_kv_tokens_casts_to_the_pool_dtype():
    pool = torch.zeros((2, BS, 1, 2), dtype=torch.bfloat16)
    vals = torch.tensor([[[1.0009765625, -2.5]]])
    tsc.write_kv_tokens(pool, np.array([1]), np.array([2]), vals)
    assert pool.dtype == torch.bfloat16
    assert pool[1, 2, 0].tolist() == [1.0, -2.5]
    assert pool.float().abs().sum() == 3.5


def test_copy_block_copies_one_block_in_place():
    pool = torch.arange(3 * BS * 2, dtype=torch.float32).view(3, BS, 2)
    before = pool.clone()
    out = tsc.copy_block(pool, 2, 0)
    assert out is pool
    assert torch.equal(pool[0], before[2])
    assert torch.equal(pool[1:], before[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absmax_roundtrip_is_within_half_a_step(dtype):
    x = torch.randn(16, 2, 8, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    codes, scale = tsc.absmax_quantize(x)
    back = codes.float() * scale[..., None]
    assert (back - x.float()).abs().max() <= 0.5 * scale.max() + 1e-6
    assert codes.abs().max() <= 127

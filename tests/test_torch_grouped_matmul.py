"""The port's grouped matmul against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX entry (on the CPU its
dense one-hot oracle), through the JAX kernel bodies ``_gmm_kernel`` and
``_gmm_drhs_kernel`` run by ``pl.pallas_call(..., interpret=True)`` over
the JAX launchers' own grid specs (built here; nothing in the JAX
package changes), and through the port: the entry, ``GroupedMatmul``'s
gradients and the kernels' plain versions, which CPU tensors take.
Tolerances: f32 1e-5 relative, elementwise and to the output's largest
magnitude (a sum of K products near zero keeps the absolute error of
its larger terms), the two sides summing in other orders; bf16 one bf16
rounding of the output (2^-8 relative) apart.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops.pallas import grouped_matmul as jgmm
from paddle_tpu_torch.ops.kernels import grouped_matmul as tgmm

RTOL = ATOL = 1e-5
E = 4

# name: (T, K, N, group sizes, block_t)
LAYOUTS = {
    "aligned": (256, 128, 96, [64, 64, 64, 64], 64),
    "ragged_empty_padding": (256, 256, 128, [64, 0, 128, 0], 64),
    "unaligned": (200, 72, 200, [37, 0, 101, 29], 64),
    "overfull": (96, 40, 24, [50, 30, 40, 10], 32),
}


def _inputs(t, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, k)).astype(np.float32),
            rng.standard_normal((E, k, n)).astype(np.float32),
            rng.standard_normal((t, n)).astype(np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=max(atol, rtol * scale))


# -- the JAX kernel bodies in interpret mode ---------------------------------

def _jax_fwd_body(lhs, rhs, tile_ids, block_t):
    """``_gmm_fwd_impl``'s grid spec around ``_gmm_kernel``."""
    t, k = lhs.shape
    e, _, n = rhs.shape
    block_n, block_k = jgmm._pick_blocks(k, n, block_t)
    n_k_tiles = k // block_k
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(t // block_t, n // block_n, n_k_tiles),
        in_specs=[pl.BlockSpec((block_t, block_k),
                               lambda i, j, kk, ids: (i, kk)),
                  pl.BlockSpec((1, block_k, block_n),
                               lambda i, j, kk, ids: (ids[i], kk, j))],
        out_specs=pl.BlockSpec((block_t, block_n),
                               lambda i, j, kk, ids: (i, j)),
        scratch_shapes=[pltpu.VMEM((block_t, block_n), jnp.float32)])
    return pl.pallas_call(
        functools.partial(jgmm._gmm_kernel, n_k_tiles=n_k_tiles),
        grid_spec=spec, out_shape=jax.ShapeDtypeStruct((t, n), lhs.dtype),
        interpret=True)(tile_ids, lhs, rhs)


def _jax_drhs_body(lhs, g, tile_ids, e, block_t):
    """``_gmm_drhs_impl``'s grid spec around ``_gmm_drhs_kernel``, with
    its mask of the experts that have no tile."""
    t, k = lhs.shape
    n = g.shape[1]
    block_n, block_k = jgmm._pick_blocks(k, n, block_t)
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(k // block_k, n // block_n, t // block_t),
        in_specs=[pl.BlockSpec((block_t, block_k),
                               lambda kk, j, i, ids: (i, kk)),
                  pl.BlockSpec((block_t, block_n),
                               lambda kk, j, i, ids: (i, j))],
        out_specs=pl.BlockSpec((1, block_k, block_n),
                               lambda kk, j, i, ids: (ids[i], kk, j)))
    out = pl.pallas_call(
        jgmm._gmm_drhs_kernel, grid_spec=spec,
        out_shape=jax.ShapeDtypeStruct((e, k, n), jnp.float32),
        interpret=True)(tile_ids, lhs, g)
    present = jnp.zeros((e,), bool).at[tile_ids].set(True)
    return jnp.where(present[:, None, None], out, 0.0)


@pytest.mark.parametrize("case", [
    # group sizes (tile-aligned) -> the entry's own tile ids
    ("sizes", [64, 0, 128, 64], None),
    # a given tile map: every tile against its id, an empty expert
    ("tile_ids", None, [0, 0, 1, 3]),
], ids=lambda c: c[0])
def test_kernels_match_the_jax_kernel_bodies(case):
    """K6 forward, K6 as dlhs and K7 against the TPU kernel bodies at
    T = K = N = 256, E 4, block_t 64."""
    _, sizes, ids = case
    t = k = n = 256
    bt = 64
    lhs, rhs, g = _inputs(t, k, n, seed=5)
    if ids is None:
        tile_ids = jgmm.tile_expert_ids(jnp.asarray(sizes), bt, t // bt)
        kw = dict(group_sizes=sizes)
    else:
        tile_ids = jnp.asarray(ids, jnp.int32)
        kw = dict(group_sizes=None, tile_ids=torch.tensor(ids))
    want = _jax_fwd_body(jnp.asarray(lhs), jnp.asarray(rhs), tile_ids, bt)
    want_dlhs = _jax_fwd_body(jnp.asarray(g),
                              jnp.swapaxes(jnp.asarray(rhs), 1, 2),
                              tile_ids, bt)
    want_drhs = _jax_drhs_body(jnp.asarray(lhs), jnp.asarray(g), tile_ids,
                               E, bt)
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = tgmm.grouped_matmul(tl, tr, block_t=bt, **kw)
    out.backward(torch.from_numpy(g))
    # the bodies agree with the dense oracle within 4.2e-5 abs at K 256
    tol = dict(rtol=RTOL, atol=1e-4)
    _close(out.detach(), want, **tol)
    _close(tl.grad, want_dlhs, **tol)
    _close(tr.grad, want_drhs, **tol)


# -- the entry against the JAX entry -----------------------------------------

@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_entry_and_gradients_match_the_jax_entry(name):
    """Forward and both gradients (``GroupedMatmul`` against ``jax.vjp``
    of the JAX entry) on ragged, empty-expert, padding, unaligned and
    over-full (Σ sizes > T) layouts."""
    t, k, n, sizes, bt = LAYOUTS[name]
    lhs, rhs, g = _inputs(t, k, n, seed=len(name))
    gs = np.asarray(sizes, np.int32)
    want, vjp = jax.vjp(
        lambda a, b: jgmm.grouped_matmul(a, b, jnp.asarray(gs), bt),
        jnp.asarray(lhs), jnp.asarray(rhs))
    want_dl, want_dr = vjp(jnp.asarray(g))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = tgmm.grouped_matmul(tl, tr, torch.from_numpy(gs), bt)
    out.backward(torch.from_numpy(g))
    assert out.shape == (t, n) and out.dtype == torch.float32
    _close(out.detach(), want)
    _close(tl.grad, want_dl)
    _close(tr.grad, want_dr)
    total = min(sum(sizes), t)
    assert not out[total:].any() and not tl.grad[total:].any()
    # the dense oracle of the port gives the same
    _close(tgmm.grouped_matmul_reference(tl.detach(), tr.detach(), sizes),
           want)


def test_bf16_entry_matches_the_jax_entry():
    t, k, n, sizes, bt = LAYOUTS["unaligned"]
    lhs, rhs, _ = _inputs(t, k, n, seed=9)
    want = jgmm.grouped_matmul(jnp.asarray(lhs, jnp.bfloat16),
                               jnp.asarray(rhs, jnp.bfloat16),
                               jnp.asarray(sizes), bt)
    got = tgmm.grouped_matmul(torch.from_numpy(lhs).bfloat16(),
                              torch.from_numpy(rhs).bfloat16(), sizes, bt)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=2 ** -8,
           atol=1e-2)


def test_plain_versions_follow_the_offsets():
    """The kernels' plain versions: rows of each range against their
    expert, zeros outside every range, an empty expert's drhs exactly
    zero, dlhs = K6 on the transposed weights."""
    t, k, n = 50, 24, 16
    lhs, rhs, g = (torch.from_numpy(a) for a in _inputs(t, k, n, seed=3))
    offsets = torch.tensor([0, 10, 10, 30, 45], dtype=torch.int32)
    out = tgmm.grouped_matmul_fwd(lhs, rhs, offsets)
    for e, (lo, hi) in enumerate([(0, 10), (10, 10), (10, 30), (30, 45)]):
        torch.testing.assert_close(out[lo:hi], lhs[lo:hi] @ rhs[e])
    assert not out[45:].any()
    dlhs = tgmm.grouped_matmul_dlhs(g, rhs, offsets)
    torch.testing.assert_close(dlhs[10:30], g[10:30] @ rhs[2].t())
    drhs = tgmm.grouped_matmul_drhs(lhs, g, offsets, E)
    assert drhs.dtype == torch.float32 and not drhs[1].any()
    torch.testing.assert_close(drhs[3], lhs[30:45].t() @ g[30:45])
    assert tgmm.grouped_matmul_fwd.launches == 0     # CPU: nothing counted


def test_tile_expert_ids_match_jax():
    sizes = np.asarray([128, 0, 256, 128, 0], np.int32)
    want = jgmm.tile_expert_ids(jnp.asarray(sizes), 64, 8)
    got = tgmm.tile_expert_ids(torch.from_numpy(sizes), 64, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = tgmm.offsets_from_tile_ids(got, 5, 64, 512, "cpu")
    np.testing.assert_array_equal(off.numpy(), [0, 128, 128, 384, 512, 512])


def test_entry_raises_where_the_jax_entry_does():
    lhs, rhs = torch.zeros(128, 16), torch.zeros(E, 16, 8)
    with pytest.raises(ValueError, match="K"):
        tgmm.grouped_matmul(lhs, torch.zeros(E, 12, 8), [32] * 4)
    bad = [0, 1, 0, 3]
    with pytest.raises(ValueError, match="non-decreasing"):
        tgmm.grouped_matmul(lhs, rhs, None, 32, tile_ids=torch.tensor(bad))
    with pytest.raises(ValueError, match="non-decreasing"):
        jgmm.grouped_matmul(jnp.zeros((128, 16)), jnp.zeros((E, 16, 8)),
                            jnp.asarray([32] * 4), 32,
                            tile_ids=jnp.asarray(bad))
    with pytest.raises(ValueError, match="entries"):
        tgmm.grouped_matmul(lhs, rhs, None, 32, tile_ids=torch.tensor([0]))
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        tgmm.grouped_matmul(lhs, rhs, None, 32,
                            tile_ids=torch.tensor([0, 1, 2, 4]))
    with pytest.raises(ValueError, match="E = 4"):
        tgmm.grouped_matmul(lhs, rhs, [64, 64])


# -- which kernel takes a CUDA call ------------------------------------------

def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _offset_by_one(*shape):
    """A contiguous bf16 tensor whose base lies 2 bytes past an aligned
    allocation."""
    return _bf16(math.prod(shape) + 1)[1:].view(*shape)


# name: (make (a, b), whether the TMA kernels take it). ``b`` is K6's
# weights view [E, R, N] or K7's g [T, N].
TMA_CASES = {
    "fwd_weights_as_stored": (lambda: (_bf16(256, 64), _bf16(4, 64, 128)),
                              True),
    "dlhs_transposed_weights": (
        lambda: (_bf16(256, 128), _bf16(4, 64, 128).transpose(1, 2)), True),
    "drhs": (lambda: (_bf16(256, 64), _bf16(256, 128)), True),
    "unaligned_layout_k200_n72": (
        lambda: (_bf16(300, 200), _bf16(6, 200, 72)), True),
    "dlhs_k200_n72": (
        lambda: (_bf16(300, 72), _bf16(6, 200, 72).transpose(1, 2)), True),
    "one_expert": (lambda: (_bf16(64, 64), _bf16(1, 64, 64)), True),
    "padded_weights_view": (
        lambda: (_bf16(64, 64), _bf16(4, 64, 136)[:, :, :128]), True),
    "float32": (lambda: (_bf16(256, 64).float(), _bf16(4, 64, 128).float()),
                False),
    "float16": (lambda: (_bf16(256, 64).half(), _bf16(4, 64, 128).half()),
                False),
    "drhs_float32": (lambda: (_bf16(256, 64).float(), _bf16(256, 128).float()),
                     False),
    "odd_k_n": (lambda: (_bf16(100, 37), _bf16(4, 37, 45)), False),
    "dlhs_odd_k_n": (
        lambda: (_bf16(100, 45), _bf16(4, 37, 45).transpose(1, 2)), False),
    "lhs_base_unaligned": (
        lambda: (_offset_by_one(256, 64), _bf16(4, 64, 128)), False),
    "weights_base_unaligned": (
        lambda: (_bf16(256, 64), _offset_by_one(4, 64, 128)), False),
    "drhs_g_base_unaligned": (
        lambda: (_bf16(256, 64), _offset_by_one(256, 128)), False),
    "weights_row_stride_not_16_bytes": (
        lambda: (_bf16(64, 64), _bf16(4, 64, 130)[:, :, :128]), False),
    "weights_strides_not_nested": (
        lambda: (_bf16(64, 64), _bf16(64, 4, 128).permute(1, 0, 2)), False),
    "weights_contiguous_along_neither": (
        lambda: (_bf16(64, 64), _bf16(4, 64, 128, 2)[..., 0]), False),
    "no_rows": (lambda: (_bf16(0, 64), _bf16(4, 64, 128)), False),
    "drhs_no_rows": (lambda: (_bf16(0, 64), _bf16(0, 128)), False),
}
# every residue of K (lhs's row) and of N (the output's row) mod 8
TMA_CASES.update({
    f"fwd_k_mod8_{r}": (lambda r=r: (_bf16(64, 64 + r), _bf16(2, 64 + r, 64)),
                        False) for r in range(1, 8)})
TMA_CASES.update({
    f"fwd_n_mod8_{r}": (lambda r=r: (_bf16(64, 64), _bf16(2, 64, 64 + r)),
                        False) for r in range(1, 8)})
TMA_CASES.update({
    f"drhs_n_mod8_{r}": (lambda r=r: (_bf16(64, 64), _bf16(64, 64 + r)),
                         False) for r in (2, 4, 6)})


@pytest.mark.parametrize("name", sorted(TMA_CASES))
def test_tma_path_predicate(name):
    """``takes_tma`` sends bf16 operands a TMA tensor map can describe
    (aligned bases, 16-byte row strides, nested weight strides) to the
    TMA / wgmma kernels and everything else to the general ones."""
    make, want = TMA_CASES[name]
    a, b = make()
    assert tgmm.takes_tma(a, b) is want


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """bf16 CPU tensors that the TMA kernels would take on the card run
    the plain versions here, and neither count moves."""
    t, k, n = 96, 64, 72
    lhs, rhs, g = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(t, k, n, seed=11))
    offsets = torch.tensor([0, 30, 30, 64, 90], dtype=torch.int32)
    assert tgmm.takes_tma(lhs, rhs) and tgmm.takes_tma(g, rhs.transpose(1, 2))
    assert tgmm.takes_tma(lhs, g)
    ws = (tgmm.grouped_matmul_fwd, tgmm.grouped_matmul_dlhs,
          tgmm.grouped_matmul_drhs)
    before = [(w.launches, w.tma_launches) for w in ws]
    got = (tgmm.grouped_matmul_fwd(lhs, rhs, offsets),
           tgmm.grouped_matmul_dlhs(g, rhs, offsets),
           tgmm.grouped_matmul_drhs(lhs, g, offsets, E))
    want = (tgmm.grouped_matmul_fwd_reference(lhs, rhs, offsets),
            tgmm.grouped_matmul_fwd_reference(g, rhs.transpose(1, 2),
                                              offsets),
            tgmm.grouped_matmul_drhs_reference(lhs, g, offsets, E))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [(w.launches, w.tma_launches) for w in ws] == before

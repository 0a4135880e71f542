"""Grouped (ragged) matmul: the Hopper kernels, their plain versions,
autograd and the op entry.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/grouped_matmul.py``
(``_gmm_kernel`` via ``_gmm_fwd_impl``, ``_gmm_drhs_kernel`` via
``_gmm_drhs_impl``) and the ``custom_vjp`` around them:
``grouped_matmul(lhs [T, K], rhs [E, K, N], group_sizes [E]) -> [T, N]``
with the rows of group e computed against ``rhs[e]`` and rows past
``sum(group_sizes)`` coming out as zeros.

Every kernel call takes row offsets: ``offsets`` int32 ``[E + 1]`` on
the tensors' device, non-decreasing, rows ``offsets[e] .. offsets[e+1]
- 1`` going to expert e (offsets are clamped to ``[0, T]``; rows no
expert owns are zeros in the forward and count nowhere in the weight
gradient). The entry builds them without reading anything on the host:
from ``group_sizes`` as a cumsum on the device, or from a given
``tile_ids`` as ``block_t`` times the number of tiles with a smaller id
(``offsets[E] = T``), which is the TPU kernel's own semantics: every
tile is computed against its id and nothing is zeroed.

Three wrappers launch the CUDA kernels of ``csrc/grouped_matmul.cu`` on
CUDA tensors and count each launch; a CPU tensor takes the plain version
of the same function (and counts nothing); there is no fallback — a
CUDA call the kernels cannot take raises. Each wrapper has two kernels:
:func:`takes_tma` chooses, before the launch, from dtype, alignment and
strides alone. bf16 operands that a TMA tensor map can describe take
the TMA / ``wgmma`` kernels (counted in ``.tma_launches`` as well as
``.launches``); f32 and the other bf16 layouts take the general
``mma.sync`` kernels:

- :func:`grouped_matmul_fwd` (K6) ``out = lhs · rhs[e]`` by rows; plain
  version :func:`grouped_matmul_fwd_reference`;
- :func:`grouped_matmul_dlhs` (K6 on the transposed weights, read in
  place through their strides) ``dlhs = g · rhs[e]ᵀ``; plain version the
  same function on ``rhs.transpose(1, 2)``;
- :func:`grouped_matmul_drhs` (K7) ``drhs[e] = Σ lhs[r]ᵀ g[r]`` over
  expert e's rows, f32; plain version :func:`grouped_matmul_drhs_reference`.

:class:`GroupedMatmul` is the ``torch.autograd.Function`` (forward K6;
backward K6 for dlhs and K7 for drhs, cast to rhs's dtype as the JAX
backward does) and :func:`grouped_matmul` the entry.
:func:`grouped_matmul_reference` is the JAX package's dense oracle (a
one-hot contraction, O(T·E·K·N)).

Numerics (the TPU kernels'): products accumulate in f32 over operands
in the input dtype; the forward and dlhs round once to the input dtype;
f32 inputs compute in true f32 (no TF32), as the JAX kernels pin f32 to
``HIGHEST``. The plain versions multiply f32 copies of the operands,
the same arithmetic up to summation order.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build as _build

__all__ = ["GroupedMatmul", "grouped_matmul", "grouped_matmul_reference",
           "grouped_matmul_fwd", "grouped_matmul_dlhs",
           "grouped_matmul_drhs", "grouped_matmul_fwd_reference",
           "grouped_matmul_drhs_reference", "takes_tma", "tile_expert_ids",
           "offsets_from_group_sizes", "offsets_from_tile_ids"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1
_lib = None


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: f32 (f64 for f64 inputs,
    which only the CPU takes)."""
    return torch.promote_types(x.dtype, torch.float32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def grouped_matmul_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                             group_sizes) -> torch.Tensor:
    """Dense oracle (the JAX ``grouped_matmul_reference``): per-row
    expert id from the cumsum of the group sizes, one-hot contraction,
    rows past the last group zeroed; in the promoted dtype.
    O(T·E·K·N) — a correctness baseline only."""
    t, e = lhs.shape[0], rhs.shape[0]
    dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    bounds = torch.cumsum(torch.as_tensor(group_sizes, device=lhs.device),
                          0)
    rows = torch.arange(t, device=lhs.device)
    row_expert = torch.searchsorted(bounds, rows, right=True)
    # an id past the last expert is an all-zero one-hot row, as in JAX
    oh = (row_expert[:, None] == torch.arange(e, device=lhs.device)).to(
        dtype)
    out = torch.einsum("tk,te,ekn->tn", lhs.to(dtype), oh, rhs.to(dtype))
    valid = rows < (bounds[-1] if e else 0)
    return out * valid[:, None].to(dtype)


def tile_expert_ids(group_sizes, block_t: int, num_tiles: int
                    ) -> torch.Tensor:
    """Expert id per token tile, given tile-aligned group sizes (every
    group size a multiple of ``block_t``); int32 ``[num_tiles]``."""
    gs = torch.as_tensor(group_sizes)
    bounds = torch.cumsum(gs, 0)
    starts = torch.arange(num_tiles, device=gs.device) * block_t
    return torch.searchsorted(bounds, starts.to(bounds.dtype),
                              right=True).to(torch.int32)


def _bounds(offsets: torch.Tensor, t: int):
    """The offsets on the host, clamped to ``[0, T]`` (the plain versions
    read them there: one sync, which the kernels avoid)."""
    return offsets.clamp(0, t).tolist()


def grouped_matmul_fwd_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """K6's function in plain PyTorch: ``out[r] = lhs[r] · rhs[e]`` for
    ``offsets[e] <= r < offsets[e+1]``, zero for rows no expert owns;
    f32 accumulation, output in lhs's dtype. ``rhs`` may be any strided
    ``[E, K, N]`` view (``rhs.transpose(1, 2)`` gives dlhs)."""
    t, e, n = lhs.shape[0], rhs.shape[0], rhs.shape[2]
    acc = _acc(lhs)
    out = torch.zeros((t, n), dtype=lhs.dtype, device=lhs.device)
    b = _bounds(offsets, t)
    for i in range(e):
        lo, hi = b[i], b[i + 1]
        if hi > lo:
            out[lo:hi] = (lhs[lo:hi].to(acc) @ rhs[i].to(acc)).to(lhs.dtype)
    return out


def grouped_matmul_drhs_reference(lhs: torch.Tensor, g: torch.Tensor,
                                  offsets: torch.Tensor,
                                  num_experts: int) -> torch.Tensor:
    """K7's function in plain PyTorch: per expert, Σ lhs[r]ᵀ g[r] over
    its rows in f32; an expert without rows is zero. ``[E, K, N]``."""
    t, k, n = lhs.shape[0], lhs.shape[1], g.shape[1]
    acc = _acc(lhs)
    out = torch.zeros((num_experts, k, n), dtype=acc, device=lhs.device)
    b = _bounds(offsets, t)
    for i in range(num_experts):
        lo, hi = b[i], b[i + 1]
        if hi > lo:
            out[i] = lhs[lo:hi].to(acc).t() @ g[lo:hi].to(acc)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("grouped_matmul")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grouped_matmul_forward.argtypes = [p, p, p, p, i, i, i, i,
                                               ll, ll, ll, i, p]
        lib.grouped_matmul_drhs.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.grouped_matmul_forward_tma.argtypes = [p, p, p, p, i, i, i, i,
                                                   ll, ll, ll, p]
        lib.grouped_matmul_drhs_tma.argtypes = [p, p, p, p, i, i, i, i, p]
        for fn in (lib.grouped_matmul_forward, lib.grouped_matmul_drhs,
                   lib.grouped_matmul_forward_tma,
                   lib.grouped_matmul_drhs_tma):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def takes_tma(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the TMA / ``wgmma`` kernels take a call, from the operands'
    dtype, sizes, alignment and strides alone (nothing is launched).

    ``a`` is lhs or g ``[T, R]`` (contiguous). ``b`` is K6's weights view
    ``[E, R, N]`` (contiguous along N as stored, or along R transposed for
    dlhs) or K7's ``g [T, N]``. They take bf16 with every size positive,
    both bases 16-byte aligned and every row stride a multiple of 16
    bytes (R and N multiples of 8; for the weights, their strided
    dimension and the expert stride too, nested as a tensor map
    describes them: the strided dimension's stride at least the
    contiguous one's extent, the expert stride at least a whole
    matrix)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        return False
    if a.dim() != 2 or b.dim() not in (2, 3) or a.numel() == 0 \
            or b.numel() == 0:
        return False
    if a.data_ptr() % 16 or b.data_ptr() % 16 or a.shape[1] % 8 \
            or b.shape[-1] % 8:
        return False
    if b.dim() == 2:                      # K7: g [T, N], contiguous
        return True
    e, r, n = b.shape
    se, sr, sn = b.stride()
    if sn == 1:                           # the weights as stored
        inner, outer, so = n, r, sr
    elif sr == 1:                         # transposed (dlhs)
        inner, outer, so = r, n, sn
    else:
        return False
    return so % 8 == 0 and so >= inner and (
        e == 1 or (se % 8 == 0 and se >= so * outer))


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           offsets: torch.Tensor, num_experts: int, b_dims: int) -> None:
    """Device, dtype, shape, contiguity and size checks of a launch: ``a``
    contiguous 2-D, ``b`` ``b_dims``-D of a's dtype, offsets int32
    ``[E + 1]``."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(a.dtype in _DTYPE_CODES, f"dtype {a.dtype} (float32 or bfloat16)")
    need(b.dtype == a.dtype, f"dtypes differ: {a.dtype} vs {b.dtype}")
    need(a.dim() == 2 and b.dim() == b_dims,
         f"shapes {tuple(a.shape)}, {tuple(b.shape)}")
    need(a.is_contiguous(), "lhs/g must be contiguous")
    need(b.device == a.device and offsets.device == a.device,
         "all tensors on one device")
    need(offsets.dtype == torch.int32 and offsets.is_contiguous()
         and offsets.shape == (num_experts + 1,),
         f"offsets must be contiguous int32 [{num_experts + 1}], got "
         f"{offsets.dtype} {tuple(offsets.shape)}")
    need(max(list(a.shape) + list(b.shape)) <= _INT32_MAX
         and num_experts < 65535, "sizes past the kernel's int32 indices")


def _launch_k6(wrapper, name: str, a: torch.Tensor, b: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """K6 on ``a [T, K]`` and the strided view ``b [E, K, N]`` (one of
    its last two strides 1)."""
    _check(name, a, b, offsets, b.shape[0], 3)
    t, k = a.shape
    e, k2, n = b.shape
    if k2 != k:
        raise ValueError(f"{name}: K {k} != {k2}")
    se, sk, sn = b.stride()
    if sn != 1 and sk != 1:
        raise ValueError(f"{name}: rhs must be contiguous along K or N, "
                         f"got strides {b.stride()}")
    out = torch.empty((t, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tma = takes_tma(a, b)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), offsets.data_ptr(),
            t, k, n, e, se, sk, sn)
    lib = _kernel_lib()
    if tma:
        rc = lib.grouped_matmul_forward_tma(*args, stream)
    else:
        rc = lib.grouped_matmul_forward(*args, _DTYPE_CODES[a.dtype], stream)
    _raise_on(rc, name, tma, t, k, n, e, a.dtype)
    wrapper.launches += 1
    wrapper.tma_launches += tma
    return out


def _raise_on(rc: int, name: str, tma: bool, t, k, n, e, dtype) -> None:
    if rc == 0:
        return
    what = "cuTensorMapEncodeTiled refused the TMA kernel's tensor maps" \
        if rc == -1 else f"kernel launch failed with cudaError {rc}"
    raise RuntimeError(f"{name}: {'TMA' if tma else 'general'} {what} "
                       f"(T={t} K={k} N={n} E={e} {dtype})")


def grouped_matmul_fwd(lhs: torch.Tensor, rhs: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Launch K6 on CUDA tensors (its plain version for CPU tensors):
    ``lhs [T, K]`` contiguous, ``rhs [E, K, N]`` contiguous along N or K,
    ``offsets`` int32 ``[E + 1]``. -> ``[T, N]`` in lhs's dtype."""
    name = "grouped_matmul_fwd"
    if not _on(lhs, name):
        return grouped_matmul_fwd_reference(lhs, rhs, offsets)
    return _launch_k6(grouped_matmul_fwd, name, lhs, rhs, offsets)


def grouped_matmul_dlhs(g: torch.Tensor, rhs: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Launch K6 on the transposed expert weights (a view: the kernel
    reads ``rhs`` in place) for ``dlhs[r] = g[r] · rhs[e]ᵀ``; its plain
    version for CPU tensors. ``g [T, N]``, ``rhs [E, K, N]``."""
    name = "grouped_matmul_dlhs"
    rhs_t = rhs.transpose(1, 2)
    if not _on(g, name):
        return grouped_matmul_fwd_reference(g, rhs_t, offsets)
    return _launch_k6(grouped_matmul_dlhs, name, g, rhs_t, offsets)


def grouped_matmul_drhs(lhs: torch.Tensor, g: torch.Tensor,
                        offsets: torch.Tensor, num_experts: int
                        ) -> torch.Tensor:
    """Launch K7 on CUDA tensors (its plain version for CPU tensors):
    ``lhs [T, K]``, ``g [T, N]`` contiguous. -> f32 ``[E, K, N]``."""
    name = "grouped_matmul_drhs"
    if not _on(lhs, name):
        return grouped_matmul_drhs_reference(lhs, g, offsets, num_experts)
    _check(name, lhs, g, offsets, num_experts, 2)
    t, k = lhs.shape
    n = g.shape[1]
    if g.shape[0] != t or not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous [{t}, N], got "
                         f"{tuple(g.shape)}")
    out = torch.empty((num_experts, k, n), dtype=torch.float32,
                      device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    tma = takes_tma(lhs, g)
    args = (lhs.data_ptr(), g.data_ptr(), out.data_ptr(), offsets.data_ptr(),
            t, k, n, num_experts)
    lib = _kernel_lib()
    if tma:
        rc = lib.grouped_matmul_drhs_tma(*args, stream)
    else:
        rc = lib.grouped_matmul_drhs(*args, _DTYPE_CODES[lhs.dtype], stream)
    _raise_on(rc, name, tma, t, k, n, num_experts, lhs.dtype)
    grouped_matmul_drhs.launches += 1
    grouped_matmul_drhs.tma_launches += tma
    return out


for _w in (grouped_matmul_fwd, grouped_matmul_dlhs, grouped_matmul_drhs):
    _w.launches = 0        # every launch
    _w.tma_launches = 0    # those of the TMA / wgmma kernel


class GroupedMatmul(torch.autograd.Function):
    """``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
    forward K6; backward K6 on the transposed weights for dlhs and K7
    for drhs (cast to rhs's dtype, as the JAX backward does)."""

    @staticmethod
    def forward(ctx, lhs, rhs, offsets):
        ctx.save_for_backward(lhs, rhs, offsets)
        return grouped_matmul_fwd(lhs, rhs, offsets)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, offsets = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_matmul_dlhs(g, rhs, offsets).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = grouped_matmul_drhs(lhs, g, offsets,
                                       rhs.shape[0]).to(rhs.dtype)
        return dlhs, drhs, None


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def offsets_from_group_sizes(group_sizes, num_experts: int, t: int,
                             device) -> torch.Tensor:
    """``[0, cumsum(group_sizes)]`` clamped to ``[0, T]``, int32 on
    ``device``: computed there, nothing read on the host."""
    gs = torch.as_tensor(group_sizes, device=device)
    if gs.shape != (num_experts,):
        raise ValueError(f"group_sizes must have E = {num_experts} "
                         f"entries, got shape {tuple(gs.shape)}")
    off = torch.zeros(num_experts + 1, dtype=torch.int64, device=device)
    off[1:] = torch.cumsum(gs.to(torch.int64), 0)
    return off.clamp_(0, t).to(torch.int32)


def offsets_from_tile_ids(tile_ids, num_experts: int, block_t: int, t: int,
                          device) -> torch.Tensor:
    """``offsets[e]`` = ``block_t`` × (tiles with id < e), ``offsets[E]``
    = T: tile i's rows go to expert ``tile_ids[i]``. Raises
    ``ValueError`` unless the ids are non-decreasing, in ``[0, E)`` and
    one per tile (``ceil(T / block_t)``). The ids are checked on the
    host: one sync when they lie on the card."""
    ids = torch.as_tensor(tile_ids).detach().to("cpu", torch.int64)
    if ids.dim() != 1:
        raise ValueError(f"tile_ids must be 1-D, got {tuple(ids.shape)}")
    if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
        raise ValueError(
            "grouped_matmul tile_ids must be non-decreasing (tokens "
            "pre-sorted by expert): the dRHS kernel walks each expert's "
            "rows as one consecutive range, so a scattered map would "
            "yield wrong weight grads. Sort tokens by expert or use "
            "grouped_matmul_reference.")
    n_tiles = math.ceil(t / block_t)
    if ids.numel() != n_tiles:
        raise ValueError(f"tile_ids has {ids.numel()} entries; {t} rows in "
                         f"tiles of {block_t} make {n_tiles}")
    if n_tiles and (int(ids[0]) < 0 or int(ids[-1]) >= num_experts):
        raise ValueError(f"tile_ids must lie in [0, {num_experts})")
    below = torch.searchsorted(ids, torch.arange(num_experts + 1))
    off = (below * block_t).clamp_(max=t)
    off[num_experts] = t
    return off.to(device=device, dtype=torch.int32)


def _rhs_layout(rhs: torch.Tensor) -> torch.Tensor:
    """``rhs`` as is when it is contiguous along N or K (the kernel reads
    either through its strides), else a contiguous copy."""
    return rhs if 1 in rhs.stride()[1:] else rhs.contiguous()


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes,
                   block_t: int = 128,
                   tile_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged matmul ``[T, K] x [E, K, N] -> [T, N]``, differentiable in
    lhs and rhs: rows of group e against ``rhs[e]``, rows past
    ``sum(group_sizes)`` zero. Unlike the TPU kernel, groups need not be
    multiples of a tile and T, K, N are free: the CUDA kernels take any
    layout, so a CUDA call always launches them (K6 forward; K6 and K7
    backward) and never falls back to the dense oracle; a call they
    cannot take raises. CPU tensors take the plain versions.

    ``tile_ids`` (one expert id per ``block_t`` rows, non-decreasing)
    gives the layout instead of ``group_sizes``, with the TPU kernel's
    semantics: every tile against its id, nothing zeroed. It raises the
    JAX entry's ``ValueError`` when the ids decrease (checking costs one
    host sync for ids on the card), and also when they leave ``[0, E)``
    or their count is not ``ceil(T / block_t)``. ``block_t`` is used
    only with ``tile_ids``: the kernels' own tiles are fixed. A K
    mismatch raises ``ValueError``. Mixed dtypes compute in the promoted
    dtype; the kernels take float32 and bfloat16."""
    t, k = lhs.shape
    e, k2, _ = rhs.shape
    if k2 != k:
        raise ValueError(f"lhs K {k} != rhs K {k2}")
    if block_t <= 0:
        raise ValueError(f"block_t must be positive, got {block_t}")
    if tile_ids is not None:
        offsets = offsets_from_tile_ids(tile_ids, e, block_t, t, lhs.device)
    else:
        offsets = offsets_from_group_sizes(group_sizes, e, t, lhs.device)
    dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    return GroupedMatmul.apply(lhs.to(dtype).contiguous(),
                               _rhs_layout(rhs.to(dtype)), offsets)

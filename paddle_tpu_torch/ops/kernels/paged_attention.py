"""Block-table paged attention: the Hopper kernels and their plain walks.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
(``_kernel`` via ``_paged_attention_call``). The functions share one
flat signature ``(q, k_pool, v_pool, tables, positions)``:

- :func:`paged_attention_reference` — the plain PyTorch walk, a port of
  the JAX package's jnp walk (``serving_cache.paged_attention`` with
  ``use_kernel=False``): an online-softmax loop over ``block_size``
  tiles that gathers one block per slot per tile. It is the kernels'
  oracle, and the path every CPU tensor takes.
- :func:`paged_attention_split_reference` — the split design's plain
  version: the same walk over each span of history columns on its own,
  the spans merged by the kernel's log-sum-exp rule. Tests and the card
  smoke run hold it against the walk and the kernel; the main path never
  takes it.
- :func:`paged_attention_kernel` — the wrapper of the CUDA kernels. For a
  CUDA tensor it checks device, dtype, shape and contiguity, allocates
  the output, launches on the current stream and raises on a non-zero
  return code. Two designs share it, and :func:`takes_split` picks one
  from dtypes and shapes: bf16 ``q`` over bf16 or int8 pools at head dim
  64 or 128 and block sizes that are multiples of 16 up to 128 take the
  split design, ``csrc/paged_attention_split.cu`` (the history split
  across CTAs and merged in the same launch, pages streamed through a
  shared-memory ring, tensor-core products for 4 or more rows a KV
  head; :func:`split_plan` sizes it); everything else the first design,
  ``csrc/paged_attention.cu`` (one CTA walks a whole history). It counts
  every launch in ``paged_attention_kernel.launches`` and those of the
  split design in ``.split_launches``, of which those on the tensor cores
  (64-row groups) in ``.mma_launches``. There is no fallback: a CUDA call
  the chosen design cannot take raises. A CPU tensor takes the plain
  walk (and counts nothing).
- ``paged_attention_op`` — the same dispatch as the ``torch.library``
  operator ``paddle_tpu_torch::paged_attention`` (with a fake kernel for
  its output shape), registered when this module is imported. The
  wrapper calls it, so eager calls, the serving engines' CUDA graphs
  (whose replays advance the counters through ``counters.py``) and
  programs exported with ``torch.export`` all reach the kernels through
  the one operator. It is registered through ``torch.library.Library``
  (a schema and a CPU and a CUDA kernel), not ``custom_op``, whose first
  call imports ``torch._dynamo`` (seconds of host in every process
  that serves).

Contract: row ``(s, t)`` attends every column ``c <= positions[s, t]``
of its slot's history; query head ``h = kvh * n_rep + r`` attends the
unexpanded KV head ``kvh``; ``k_scale``/``v_scale`` (int8 pools) switch
the tile load to dequantization; every gathered tile goes through
``nan_to_num`` and masked columns contribute exactly zero; tiles at or
past ``n_tiles`` are skipped.

Numerics. The walk follows the JAX walk's roundings: dequantized tiles
are cast to q's dtype, and the probabilities are cast to V's dtype
before the PV product (both dots accumulate in f32). The kernels keep
f32 from the load to the output cast, as the TPU kernel does (the split
design's tensor-core products take exact bf16 operands, the int8 scales
outside the products and P as a bf16 hi + lo pair). In f32 the two
differ only by summation order; in bf16 they differ by those bf16
roundings.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from . import build as _build

__all__ = ["paged_attention_reference", "paged_attention_split_reference",
           "paged_attention_kernel", "paged_attention_op", "takes_split",
           "split_plan"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
# the split design: rows of a (slot, KV head) that take the tensor cores
# and their group, the span a CTA walks (columns) and its limits, the
# partial states' size
_MMA_ROWS = 4
_MMA_GROUP = 64
_SPAN = 256
_MAX_SPAN = 2048
_MAX_SPANS = 64
_PARTIAL_BYTES = 16 << 20
_lib = None
_split_lib = None
_ticket_bufs: Dict[Tuple[int, int], torch.Tensor] = {}
_retired_tickets: List[torch.Tensor] = []
_sm_counts: Dict[int, int] = {}


def _walk(q, k_pool, v_pool, tables, positions, block_size: int, R: int,
          n_walk, k_scale, v_scale, lo: int = 0,
          hi: Optional[int] = None):
    """The walk's online-softmax state ``(m, l, acc)``, f32 ``[S, K, R,
    T]`` (``acc`` with a trailing ``D``), over the history columns
    ``[lo, hi)`` of every slot: the block tiles that meet the range, in
    order, with the columns outside it masked like those past a row's
    position. ``n_walk`` is ``(tiles, bound)`` from :func:`_n_walk`: a
    device bound masks the columns at or past ``bound * block_size``
    (a fully masked tile leaves the state exactly as it was)."""
    n_walk, bound = n_walk
    S, T, H, D = q.shape
    K = k_pool.shape[2]
    dev = q.device
    q5 = q.reshape(S, T, K, R, D).float()
    inv_sqrt_d = 1.0 / math.sqrt(D)
    cols0 = torch.arange(block_size, device=dev)
    pos = positions.to(dev)
    tables = tables.to(dev).long()
    hi = n_walk * block_size if hi is None else hi
    m = torch.full((S, K, R, T), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, K, R, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, K, R, T, D), dtype=torch.float32, device=dev)
    for i in range(lo // block_size,
                   min(n_walk, -(-hi // block_size))):
        phys = tables[:, i].clamp(min=0)               # [S]
        k_t = k_pool[phys]                             # [S, bs, K, D]
        v_t = v_pool[phys]
        if k_scale is not None:
            k_t = (k_t.float() * k_scale[phys][..., None]).to(q.dtype)
            v_t = (v_t.float() * v_scale[phys][..., None]).to(q.dtype)
        # recycled blocks may hold NaN/inf from an earlier request:
        # masked columns must contribute EXACTLY zero, and 0 * NaN is
        # NaN in the PV product — sanitize every gathered tile
        k_t = torch.nan_to_num(k_t)
        v_t = torch.nan_to_num(v_t)
        s = torch.einsum("stkrd,sbkd->skrtb", q5, k_t.float()) * inv_sqrt_d
        cols = i * block_size + cols0
        live = (cols >= lo) & (cols < hi)
        if bound is not None:
            live = live & (cols < bound * block_size)
        ok = (cols[None, None, :] <= pos[:, :, None]) & live[None, None, :]
        okb = ok[:, None, None, :, :]                  # [S, 1, 1, T, bs]
        s = torch.where(okb, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row has s == m_new == -1e30 and exp() gives 1:
        # re-mask p so its contribution is exactly zero
        p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("skrtb,sbkd->skrtd", p.to(v_t.dtype).float(),
                          v_t.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return m, l, acc


def _shape_out(acc, q):
    S, T, H, D = q.shape
    return acc.permute(0, 3, 1, 2, 4).reshape(S, T, H, D).to(q.dtype)


def _n_walk(tables, n_tiles):
    """``(tiles to walk, device bound or None)``. Inside a CUDA graph
    capture a tile count on the card cannot be read on the host: every
    table column is walked and the bound masks. Elsewhere the count is
    read and bounds the loop."""
    MB = tables.shape[1]
    if n_tiles is None:
        return MB, None
    if isinstance(n_tiles, torch.Tensor) and n_tiles.is_cuda \
            and torch.cuda.is_current_stream_capturing():
        return MB, n_tiles.reshape(()).long()
    return min(int(n_tiles), MB), None


def _heads(q, k_pool, n_rep) -> int:
    K, R = k_pool.shape[2], int(n_rep)
    if K * R != q.shape[2]:
        raise ValueError(f"KV heads {K} x n_rep {R} != query heads "
                         f"{q.shape[2]}")
    return R


def paged_attention_reference(q, k_pool, v_pool, tables, positions, *,
                              block_size: int, n_rep: int,
                              n_tiles: Union[int, torch.Tensor, None] = None,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain tiled walk (see the module docstring). ``q [S, T, H, D]``,
    pools ``[num_blocks, block_size, KVH, D]``, ``tables [S, MB]``
    (entry < 0 = unmapped), ``positions [S, T]``."""
    R = _heads(q, k_pool, n_rep)
    _, l, acc = _walk(q, k_pool, v_pool, tables, positions, block_size, R,
                      _n_walk(tables, n_tiles), k_scale, v_scale)
    return _shape_out(acc / l.clamp(min=1e-30)[..., None], q)


def paged_attention_split_reference(
        q, k_pool, v_pool, tables, positions, *, block_size: int,
        n_rep: int, n_tiles: Union[int, torch.Tensor, None] = None,
        k_scale=None, v_scale=None, span: int = 256) -> torch.Tensor:
    """The split design's plain version: the walk over each span of
    ``span`` history columns on its own (the walk's arithmetic), then the
    spans merged by the kernel's log-sum-exp rule: ``M = max m_i``,
    ``w_i = exp(m_i - M)``, ``out = sum w_i acc_i / max(sum w_i l_i,
    1e-30)``. A span with no live column (m = -1e30, l = 0, acc = 0)
    adds exactly zero; a row with no live column at all gives 0."""
    R = _heads(q, k_pool, n_rep)
    n_walk = _n_walk(tables, n_tiles)
    states = [_walk(q, k_pool, v_pool, tables, positions, block_size, R,
                    n_walk, k_scale, v_scale, lo, lo + span)
              for lo in range(0, max(n_walk[0], 1) * block_size, span)]
    m_all = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        w = torch.exp(m - m_all)
        l_all = l_all + l * w
        acc = acc + a * w[..., None]
    return _shape_out(acc / l_all.clamp(min=1e-30)[..., None], q)


def _kernel_lib():
    """The first design's library, ``csrc/paged_attention.cu``."""
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_lib_split():
    """The split design's library, ``csrc/paged_attention_split.cu``."""
    global _split_lib
    if _split_lib is None:
        lib = _build.load("paged_attention_split")
        fn = lib.paged_attention_split_forward
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.paged_attention_split_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        occ.restype = ctypes.c_int
        _split_lib = lib
    return _split_lib


def takes_split(q, k_pool, tables) -> bool:
    """Whether the split design (``csrc/paged_attention_split.cu``) takes
    a call, from dtypes and shapes alone (nothing is read or launched):
    bf16 ``q`` over bf16 or int8 pools, head dim 64 or 128, a block size
    that is a multiple of 16 up to 128 (the paged engine's 16, the dense
    engine's 128-column tiles), and a table whose ``MB * block_size``
    columns fit 64 spans of at most 2048. Everything else (f32 ``q`` or
    pools, other block sizes) takes the first design."""
    if q.dtype != torch.bfloat16 \
            or k_pool.dtype not in (torch.bfloat16, torch.int8):
        return False
    if q.dim() != 4 or k_pool.dim() != 4 or tables.dim() != 2:
        return False
    bs = k_pool.shape[1]
    return (q.shape[-1] in _HEAD_DIMS and bs % 16 == 0 and 16 <= bs <= 128
            and tables.shape[1] * bs <= _MAX_SPAN * _MAX_SPANS)


def split_plan(T: int, n_rep: int, S: int, KVH: int, D: int,
               block_size: int, max_blocks: int,
               sms: int = 132) -> Tuple[int, int, int, int]:
    """The split design's launch from shapes: ``(group_rows, units,
    span, n_span_max)``. A (slot, KV head) has ``T * n_rep`` query rows:
    at least 4 (the tensor cores were faster from 4 rows up in
    ``paged_variants.py``'s runs) take the tensor cores in 64-row
    groups, fewer the CUDA cores in groups of 1 or 4. The span starts at
    256 columns; a tensor-core launch of fewer than 4 CTAs an SM (``sms``
    on the card) halves it to 128, so that its live CTAs spread over the
    SMs (a 64-row prefill chunk on an H100: 0.0261 ms against 0.0310 at
    256 columns, ``paged_variants.py``); then it
    doubles (to 2048 at most) while the history would need more than 64
    spans or the partial states more than 16 MiB."""
    rows = T * n_rep
    if rows >= _MMA_ROWS:
        g = _MMA_GROUP
    else:
        g = 1 if rows == 1 else 4
    units = S * KVH * -(-rows // g)
    cols = max_blocks * block_size
    span = _SPAN
    if g == _MMA_GROUP and units * -(-cols // span) < 4 * sms:
        span //= 2
    while span < _MAX_SPAN and (
            -(-cols // span) > _MAX_SPANS
            or units * -(-cols // span) * g * D * 4 > _PARTIAL_BYTES):
        span *= 2
    return g, units, span, -(-cols // span)


def _sms(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The int32 tickets of a (device, stream): zeros, and the kernel
    leaves them zero, so one allocation serves every call. A CUDA graph
    captured on the stream holds the buffer's address, so a buffer that
    grows is replaced but never freed."""
    key = (device.index, stream)
    buf = _ticket_bufs.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired_tickets.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _ticket_bufs[key] = buf
    return buf


def launch_split(q, k_pool, v_pool, tables, positions, n_tiles, out,
                 k_scale=None, v_scale=None, *, group_rows: int, span: int,
                 n_rep: int) -> None:
    """One launch of the split design on checked CUDA tensors
    (``n_tiles`` a one-element int32 tensor), with the scratch its plan
    needs; raises when the entry refuses or the launch fails."""
    S, T, H, D = q.shape
    NB, bs, K, _ = k_pool.shape
    MB = tables.shape[1]
    rows = T * int(n_rep)
    units = S * K * -(-rows // group_rows)
    n_span = -(-MB * bs // span)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = ml = tickets = None
    if n_span > 1:
        part = torch.empty(units * n_span * group_rows * D,
                           dtype=torch.float32, device=q.device)
        ml = torch.empty(units * n_span * group_rows * 2,
                         dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, units)
    quant = k_scale is not None
    rc = _kernel_lib_split().paged_attention_split_forward(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), positions.data_ptr(), n_tiles.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        ml.data_ptr() if ml is not None else None,
        tickets.data_ptr() if tickets is not None else None,
        S, T, H, K, D, bs, MB, NB, _DTYPE_CODES[k_pool.dtype], group_rows,
        span, stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention split kernel launch failed with cudaError "
            f"{rc} (S={S} T={T} H={H} KVH={K} D={D} bs={bs} MB={MB} "
            f"pools={k_pool.dtype} group_rows={group_rows} span={span})")


def _check(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
           block_size: int, n_rep: int) -> None:
    def need(cond, msg):
        if not cond:
            raise ValueError(f"paged_attention_kernel: {msg}")

    dev = q.device
    need(q.dim() == 4, f"q must be [S, T, H, D], got {tuple(q.shape)}")
    S, T, H, D = q.shape
    need(q.dtype in (torch.float32, torch.bfloat16),
         f"q dtype {q.dtype} (float32 or bfloat16)")
    need(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    need(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
         f"pools must share one [NB, bs, KVH, D] shape, got "
         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    NB, bs, K, Dk = k_pool.shape
    need(bs == block_size and Dk == D,
         f"pool [*, {bs}, *, {Dk}] vs block_size {block_size}, D {D}")
    need(K * n_rep == H, f"KV heads {K} x n_rep {n_rep} != heads {H}")
    need(k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPE_CODES,
         f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    quant = k_pool.dtype == torch.int8
    need(quant == (k_scale is not None) == (v_scale is not None),
         "int8 pools need k_scale and v_scale, other pools neither")
    if quant:
        for sc in (k_scale, v_scale):
            need(sc.dtype == torch.float32
                 and tuple(sc.shape) == (NB, bs, K),
                 f"scales must be float32 [{NB}, {bs}, {K}], got "
                 f"{sc.dtype} {tuple(sc.shape)}")
    need(tables.dtype == torch.int32 and tables.dim() == 2
         and tables.shape[0] == S,
         f"tables must be int32 [{S}, MB], got {tables.dtype} "
         f"{tuple(tables.shape)}")
    need(positions.dtype == torch.int32
         and tuple(positions.shape) == (S, T),
         f"positions must be int32 [{S}, {T}], got {positions.dtype} "
         f"{tuple(positions.shape)}")
    ts = [q, k_pool, v_pool, tables, positions]
    if quant:
        ts += [k_scale, v_scale]
    need(all(t.device == dev for t in ts), "all tensors on one device")
    need(all(t.is_contiguous() for t in ts), "all tensors contiguous")


def _launch(q, k_pool, v_pool, tables, positions, n_tiles, k_scale,
            v_scale, block_size: int, n_rep: int) -> torch.Tensor:
    """The kernel path of the operator on checked CUDA tensors
    (``n_tiles`` a device int32 tensor of one element, or None for every
    table column): the split design where :func:`takes_split` says, the
    first design otherwise; advances the counters."""
    _check(q, k_pool, v_pool, tables, positions, k_scale, v_scale,
           block_size, n_rep)
    S, T, H, D = q.shape
    NB, _, K, _ = k_pool.shape
    MB = tables.shape[1]
    if n_tiles is None:
        # a fill kernel, not a host copy: legal inside a graph capture
        n_tiles = torch.full((1,), MB, dtype=torch.int32, device=q.device)
    if n_tiles.dtype != torch.int32 or n_tiles.numel() != 1 \
            or n_tiles.device != q.device:
        raise ValueError("paged_attention_kernel: n_tiles must be a "
                         "one-element int32 tensor on q's device")
    out = torch.empty_like(q)
    if takes_split(q, k_pool, tables):
        g, _, span, _ = split_plan(T, n_rep, S, K, D, block_size, MB,
                                   _sms(q.device))
        launch_split(q, k_pool, v_pool, tables, positions, n_tiles, out,
                     k_scale, v_scale, group_rows=g, span=span, n_rep=n_rep)
        paged_attention_kernel.split_launches += 1
        if g == _MMA_GROUP:
            paged_attention_kernel.mma_launches += 1
    else:
        quant = k_scale is not None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_lib().paged_attention_forward(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), positions.data_ptr(), n_tiles.data_ptr(),
            out.data_ptr(), S, T, H, K, D, block_size, MB, NB,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                f"paged_attention kernel launch failed with cudaError {rc} "
                f"(S={S} T={T} H={H} KVH={K} D={D} bs={block_size} "
                f"q={q.dtype} pools={k_pool.dtype})")
    paged_attention_kernel.launches += 1
    return out


def _paged_attention_impl(q, k_pool, v_pool, tables, positions, n_tiles,
                          k_scale, v_scale, block_size, n_rep):
    """K3 as the operator ``paddle_tpu_torch::paged_attention``: ``(q,
    k_pool, v_pool, tables, positions, n_tiles or None, k_scale or None,
    v_scale or None, block_size, n_rep) -> out`` (``q``'s shape, dtype
    and device). On CUDA tensors it launches what :func:`_launch`
    launches (no fallback; the counters advance), on CPU tensors it runs
    the plain walk. Eager calls, CUDA graph captures (the serving
    engines' ``capture_jit`` programs) and programs exported with
    ``torch.export`` (``export_decode``) all reach the kernels through
    it: an exported program holds the operator, and a process that
    loads one registers it by importing this module."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, tables, positions, block_size=block_size,
            n_rep=n_rep, n_tiles=n_tiles, k_scale=k_scale, v_scale=v_scale)
    return _launch(q, k_pool, v_pool, tables, positions, n_tiles, k_scale,
                   v_scale, int(block_size), int(n_rep))


_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("paged_attention(Tensor q, Tensor k_pool, Tensor v_pool, "
            "Tensor tables, Tensor positions, Tensor? n_tiles, "
            "Tensor? k_scale, Tensor? v_scale, int block_size, "
            "int n_rep) -> Tensor")
_LIB.impl("paged_attention", _paged_attention_impl, "CPU")
_LIB.impl("paged_attention", _paged_attention_impl, "CUDA")


@torch.library.register_fake("paddle_tpu_torch::paged_attention", lib=_LIB)
def _paged_attention_fake(q, k_pool, v_pool, tables, positions, n_tiles,
                          k_scale, v_scale, block_size, n_rep):
    return torch.empty_like(q)


# the operator's overload: what the wrapper, the graphs and an exported
# program call
paged_attention_op = torch.ops.paddle_tpu_torch.paged_attention.default


def paged_attention_kernel(q, k_pool, v_pool, tables, positions, *,
                           block_size: int, n_rep: int,
                           n_tiles: Union[int, torch.Tensor, None] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Run K3 through its operator (``paged_attention_op``): the
    Hopper kernel on CUDA tensors, the plain walk on CPU tensors.
    ``n_tiles`` may be an int or a device int32 tensor of one element
    (what the engines pass: their programs compute it on the card, so a
    captured step reads it from device memory); ``None`` walks every
    table column. An int becomes a one-element tensor made by a fill,
    never a host copy."""
    if q.device.type not in ("cpu", "cuda"):
        # a meta tensor would reach the fake kernel: refuse it here
        raise ValueError(f"paged_attention_kernel runs on cuda or cpu "
                         f"tensors, got {q.device}")
    if n_tiles is not None and not isinstance(n_tiles, torch.Tensor):
        n_tiles = torch.full((1,), int(n_tiles), dtype=torch.int32,
                             device=q.device)
    return paged_attention_op(q, k_pool, v_pool, tables, positions,
                              n_tiles, k_scale, v_scale, int(block_size),
                              int(n_rep))


paged_attention_kernel.launches = 0        # every launch
paged_attention_kernel.split_launches = 0  # those of the split design
paged_attention_kernel.mma_launches = 0    # ... on the tensor cores

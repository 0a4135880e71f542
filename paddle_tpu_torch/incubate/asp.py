"""ASP: automatic structured (n:m, by default 2:4) sparsity.

The port of ``paddle_tpu.incubate.asp``: the mask algorithms run on the
host in numpy (``mask_1d``, ``mask_2d_greedy``, ``mask_2d_best``), as in
JAX; :func:`prune_model` multiplies each prunable weight by its mask in
place and remembers the mask as a device tensor; :func:`decorate`'s
optimizer multiplies the masked weights again after every step — device
ops, in place, so a ``decorate``d fused optimizer under a captured
``TrainStep`` keeps its masks inside the CUDA graph
(``jit.sot.CapturedStep`` holds the inner optimizer's state and calls the
wrapper's ``step``). Masks are keyed by the parameter tensor (a weak
reference guards against a reused ``id``).
"""
from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["calculate_density", "check_mask_2d", "check_sparsity",
           "create_mask", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "OptimizerWithSparsityGuarantee"]

_excluded_layers: List[str] = []
# id(param) -> (weakref(param), mask on the param's device and dtype)
_masks: Dict[int, Tuple["weakref.ref", torch.Tensor]] = {}


def _raw(p) -> torch.Tensor:
    return p._t if isinstance(p, Tensor) else p


def _host(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(x)


def _mask_for(p) -> Optional[torch.Tensor]:
    entry = _masks.get(id(p))
    if entry is None:
        return None
    ref, mask = entry
    if ref() is not p:  # a stale entry whose id was reused
        del _masks[id(p)]
        return None
    return mask


def set_excluded_layers(param_names, main_program=None):
    """Parameters (by name or dotted prefix) never pruned."""
    _excluded_layers.extend(param_names)


def reset_excluded_layers(main_program=None):
    _excluded_layers.clear()


def calculate_density(x) -> float:
    """The share of nonzero entries."""
    arr = _host(x)
    return float(np.count_nonzero(arr)) / max(arr.size, 1)


_MASK_ALGOS = ("mask_1d", "mask_2d_greedy", "mask_2d_best")


def _blocks_2d(arr: np.ndarray, m: int):
    """Zero-pad a 2-D array to multiples of m and tile it into
    (n_blocks, m, m) blocks (row-major block order)."""
    pad_r = (-arr.shape[0]) % m
    pad_c = (-arr.shape[1]) % m
    p = np.pad(arr, ((0, pad_r), (0, pad_c)))
    rows, cols = p.shape
    blocks = (p.reshape(rows // m, m, cols // m, m)
              .transpose(0, 2, 1, 3).reshape(-1, m, m))
    return blocks, (rows, cols)


def _unblock_2d(blocks, padded_shape, orig_shape, m: int) -> np.ndarray:
    rows, cols = padded_shape
    out = (blocks.reshape(rows // m, cols // m, m, m)
           .transpose(0, 2, 1, 3).reshape(rows, cols))
    return out[:orig_shape[0], :orig_shape[1]]


def _mask_2d_greedy(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """Per m x m block, admit entries in descending |value| order while
    the entry's row and column each hold fewer than n."""
    blocks, pshape = _blocks_2d(np.abs(mat), m)
    n_blocks = len(blocks)
    order = np.argsort(-blocks.reshape(n_blocks, -1), axis=1)
    masks = np.zeros_like(blocks)
    row_used = np.zeros((n_blocks, m), np.int64)
    col_used = np.zeros((n_blocks, m), np.int64)
    bidx = np.arange(n_blocks)
    for rank in range(m * m):
        i, j = np.divmod(order[:, rank], m)
        ok = (row_used[bidx, i] < n) & (col_used[bidx, j] < n)
        masks[bidx[ok], i[ok], j[ok]] = 1.0
        row_used[bidx[ok], i[ok]] += 1
        col_used[bidx[ok], j[ok]] += 1
    return _unblock_2d(masks, pshape, mat.shape, m)


_patterns_2d_cache: Dict[Tuple[int, int], np.ndarray] = {}


def _valid_2d_patterns(n: int, m: int) -> np.ndarray:
    """Every m x m 0/1 pattern with n ones a row and at most n a column,
    as a (P, m, m) array."""
    key = (n, m)
    cached = _patterns_2d_cache.get(key)
    if cached is not None:
        return cached
    if m > 6:
        raise NotImplementedError(
            f"mask_2d_best pattern enumeration is exponential in m "
            f"(got m={m}); use mask_2d_greedy for m > 6")
    row_choices = []
    for keep in itertools.combinations(range(m), n):
        row = np.zeros(m)
        row[list(keep)] = 1.0
        row_choices.append(row)
    pats: List[np.ndarray] = []

    def _extend(chosen, col_sum):
        if len(chosen) == m:
            pats.append(np.stack(chosen))
            return
        for row in row_choices:
            new_sum = col_sum + row
            if (new_sum <= n).all():
                _extend(chosen + [row], new_sum)

    _extend([], np.zeros(m))
    out = np.stack(pats)
    _patterns_2d_cache[key] = out
    return out


def _mask_2d_best(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """The valid pattern of largest retained |value| sum, per block."""
    pats = _valid_2d_patterns(n, m)
    blocks, pshape = _blocks_2d(np.abs(mat), m)
    scores = blocks.reshape(len(blocks), -1) @ pats.reshape(len(pats), -1).T
    masks = pats[np.argmax(scores, axis=1)]
    return _unblock_2d(masks, pshape, mat.shape, m)


def _as_2d(arr: np.ndarray) -> np.ndarray:
    return arr.reshape(1, -1) if arr.ndim == 1 else \
        arr.reshape(-1, arr.shape[-1])


def create_mask(x, func_name: str = "mask_1d", n: int = 2,
                m: int = 4) -> np.ndarray:
    """The n:m mask of ``x`` (numpy, ``x``'s dtype): ``mask_1d`` keeps
    the n largest-magnitude entries of every m consecutive ones along the
    last dim; the 2-D algorithms build m x m block patterns with at most
    n survivors a row and a column."""
    if func_name not in _MASK_ALGOS:
        raise NotImplementedError(
            f"mask algorithm {func_name!r} not supported (available: "
            f"{_MASK_ALGOS})")
    arr = _host(x)
    if func_name in ("mask_2d_greedy", "mask_2d_best"):
        algo = _mask_2d_greedy if func_name == "mask_2d_greedy" \
            else _mask_2d_best
        mask2d = algo(_as_2d(arr.astype(np.float64)), n, m)
        return mask2d.reshape(arr.shape).astype(arr.dtype)
    flat = arr.reshape(-1, arr.shape[-1])
    if arr.shape[-1] % m != 0:
        raise ValueError(
            f"last dim {arr.shape[-1]} must be divisible by m={m}")
    groups = flat.reshape(flat.shape[0], -1, m)
    order = np.argsort(-np.abs(groups), axis=-1)
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, order[..., :n], 1.0, axis=-1)
    return mask.reshape(arr.shape).astype(arr.dtype)


def check_mask_2d(x, n: int = 2, m: int = 4) -> bool:
    """Every m x m block has at most n nonzeros a row and a column."""
    arr = _as_2d(_host(x))
    blocks, _ = _blocks_2d(arr, m)
    nz = blocks != 0
    return bool((nz.sum(axis=2) <= n).all() and (nz.sum(axis=1) <= n).all())


def check_sparsity(x, n: int = 2, m: int = 4,
                   func_name: str = "check_1d") -> bool:
    """``check_1d``: every m-group along the last dim has at most n
    nonzeros; ``check_2d``: the block property. Mask-algorithm names map
    to their checking method."""
    to_check = {"check_1d": "check_1d", "mask_1d": "check_1d",
                "check_2d": "check_2d", "mask_2d_greedy": "check_2d",
                "mask_2d_best": "check_2d"}
    if func_name not in to_check:
        raise NotImplementedError(
            f"unknown check {func_name!r} (available: "
            f"{sorted(to_check)})")
    if to_check[func_name] == "check_2d":
        return check_mask_2d(x, n, m)
    arr = _host(x)
    if arr.shape[-1] % m != 0:
        return False
    groups = arr.reshape(-1, arr.shape[-1] // m, m)
    return bool((np.count_nonzero(groups, axis=-1) <= n).all())


def _excluded(name: str) -> bool:
    """An exact name or a dotted prefix ('0.weight' must not exclude
    '10.weight')."""
    for ex in _excluded_layers:
        if name == ex or name.startswith(ex + "."):
            return True
    return False


def _prunable(name: str, p: torch.Tensor) -> bool:
    if _excluded(name):
        return False
    # weights of the FC and conv layers, not biases and norms
    return p.dim() >= 2 and p.shape[-1] % 4 == 0


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Multiply the model's prunable weights by their n:m masks in place;
    ``with_mask`` keeps the masks for :func:`decorate`'s optimizer.
    Returns ``{name: mask}`` (device tensors)."""
    for k in [k for k, (ref, _) in _masks.items() if ref() is None]:
        del _masks[k]
    pruned = {}
    for name, p in model.named_parameters():
        p = _raw(p)
        if not _prunable(name, p):
            continue
        mask = torch.as_tensor(create_mask(p, mask_algo, n, m)).to(
            device=p.device, dtype=p.dtype)
        with torch.no_grad():
            p.mul_(mask)
        if with_mask:
            _masks[id(p)] = (weakref.ref(p), mask)
        pruned[name] = mask
    return pruned


class OptimizerWithSparsityGuarantee:
    """The wrapped optimizer's step, then each masked parameter
    multiplied by its mask in place, so pruned weights stay exactly
    zero through training. Its step adds only device ops to the inner
    one, so a captured step holds the inner optimizer's state and
    records this step (``_capture_inner``)."""

    _capture_inner = True

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    @torch.no_grad()
    def _apply_masks(self):
        for p in self._optimizer._parameter_list:
            mask = _mask_for(p)
            if mask is not None:
                p.mul_(mask)

    def step(self, *args, **kwargs):
        out = self._optimizer.step(*args, **kwargs)
        self._apply_masks()
        return out

    def minimize(self, loss, *args, **kwargs):
        res = self._optimizer.minimize(loss, *args, **kwargs)
        self._apply_masks()
        return res


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    return OptimizerWithSparsityGuarantee(optimizer)

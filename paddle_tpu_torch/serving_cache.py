"""Paged KV cache for generation serving: block pool, block tables,
and the block-table paged-attention seam.

The port of ``paddle_tpu.serving_cache``. The dense serving cache
(``serving.LlamaDecodeEngine``) holds ``max_seq`` K/V rows per slot per
layer whether a slot is full or idle; this module replaces those rows
with a **shared per-layer block pool** ``[num_blocks, block_size, KVH,
D]`` plus per-slot **block tables** mapping logical block index ->
physical block, so device memory scales with *active tokens*.

Three pieces live here:

- :class:`PagedKVCache` — the HOST side, ported line for line: a
  free-list block allocator with admission-time budget reservations
  (a request is admitted only if its worst-case block count fits, so
  extension at step boundaries can never fail mid-decode), per-slot
  block tables, a content-addressed radix tree over committed prompt
  blocks (``FLAGS_serving_prefix_cache``: admission aliases a hot
  prefix instead of re-prefilling it, with copy-on-write at the
  boundary), and the block-pool telemetry (``serving.blocks_free`` /
  ``blocks_used`` gauges, ``block_evictions_total``, flight events).
- :func:`paged_attention` — the DEVICE seam every engine's attention
  goes through. A CUDA tensor launches the hand-written Hopper kernel
  (``ops.kernels.paged_attention``) or raises; a CPU tensor takes the
  plain walk. The walk runs on the card only when a caller asks for it
  by name (``use_kernel=False``).
- :func:`kv_write_rows` / :func:`write_kv_rows` — the engines' write
  plan on the card (fixed shapes, no host sync; dropped rows land in a
  sink block past the ``num_blocks`` a table can map) and its scatter;
  :func:`write_kv_tokens` / :func:`plan_kv_writes` plan on the host for
  host callers. :func:`absmax_quantize` is the optional int8 block
  storage (symmetric absmax codes with per-(token, head) scales),
  :func:`copy_block` / :func:`copy_block_device` the copy-on-write
  block copy. Where the JAX package donates the pools to a jitted step,
  these update the pool tensors IN PLACE.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .observability import flight as _flight
from .observability import metrics as _om
from .ops.kernels import paged_attention as _pk

__all__ = ["PagedKVCache", "paged_attention", "write_kv_tokens",
           "absmax_quantize", "use_kernel_default", "copy_block",
           "KVWritePlan", "plan_kv_writes", "scatter_kv", "kv_write_rows",
           "write_kv_rows", "copy_block_device"]

_M = _om.scope("serving")
_G_blocks_free = _M.gauge(
    "blocks_free",
    "Paged KV pool blocks available for admission (free minus "
    "outstanding budget reservations)")
_G_blocks_used = _M.gauge(
    "blocks_used", "Paged KV pool blocks physically mapped to slots")
_M_evictions = _M.counter(
    "block_evictions_total",
    "Paged KV blocks reclaimed from expired/failed/cancelled requests "
    "(normal completion frees blocks without counting here)")


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


class _PrefixNode:
    """One radix-tree node: the edge from ``parent`` is labeled by a
    full ``block_size``-token id chunk (``key``) and owns exactly one
    physical block holding that chunk's K/V rows. ``ref`` counts the
    slot tables currently aliasing the block (NOT including the cache
    itself): ref 0 means *cached* — still matchable, reclaimable by
    the LRU eviction pass when the free list runs dry. ``stamp`` is a
    monotonic last-release tick, so eviction is leaf-first
    least-recently-released.

    Invariant (every match/release refs the WHOLE path root->node):
    ``parent.ref >= child.ref`` — a ref-0 node's entire subtree is
    ref 0, so counting ref-0 nodes counts exactly the reclaimable
    supply."""

    __slots__ = ("key", "parent", "children", "block", "ref", "stamp")

    def __init__(self, key: Optional[tuple], parent: "_PrefixNode",
                 block: int = -1):
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.block = block
        self.ref = 0
        self.stamp = 0


class PagedKVCache:
    """Host-side paged-KV bookkeeping: free-list allocator + block
    tables + budget reservations.

    The invariant that makes mid-decode exhaustion impossible:
    ``len(free) >= reserved_total`` at all times. ``admit`` only
    succeeds when the request's WORST-CASE block count (prompt +
    generation budget) fits into ``free - reserved_total``; blocks
    for the prompt are mapped immediately, the rest stay *reserved*
    and are materialized one at a time by ``ensure_token`` as decode
    crosses block boundaries. ``release`` returns both.

    Thread safety: mutations are guarded by an instrumented lock
    (``analysis.locks.make_lock``) — the server loop is the only
    writer in production, but tests and direct engine use may churn
    from other threads.
    """

    def __init__(self, max_slots: int, max_seq: int, block_size: int,
                 num_blocks: int,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_blocks: Optional[int] = None):
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_blocks_per_slot = _ceil_div(max_seq, self.block_size)
        self.num_blocks = int(num_blocks)
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        # logical block index -> physical block id; -1 = unmapped. The
        # decode step receives this (as a device array) every step and
        # drops writes/reads through unmapped entries.
        self.block_tables = np.full(
            (int(max_slots), self.max_blocks_per_slot), -1, np.int32)
        # LIFO free list popping block 0 first (stable tests/debug)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self._reserved_total = 0
        self.evictions = 0
        # -- prefix radix cache (FLAGS_serving_prefix_cache) ----------
        from .core.flags import flag_value
        self.prefix_enabled = bool(
            flag_value("serving_prefix_cache") if prefix_cache is None
            else prefix_cache)
        self.prefix_cap = int(
            flag_value("serving_prefix_cache_blocks")
            if prefix_cache_blocks is None else prefix_cache_blocks)
        self._root = _PrefixNode(None, None)  # type: ignore[arg-type]
        self._by_block: Dict[int, _PrefixNode] = {}
        self._evictable = 0                # tree nodes at ref 0
        self._stamp = itertools.count(1)   # LRU release ticks
        self._shared: Dict[int, List[int]] = {}   # slot -> aliased blocks
        self._tail: Dict[int, _PrefixNode] = {}   # slot -> deepest node
        self._matched: Dict[int, int] = {}        # slot -> skip tokens
        self._cow_pending: Dict[int, Tuple[int, int]] = {}
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        from .analysis.locks import make_lock
        self._lock = make_lock("serving.kv_pool")
        self._sync_gauges()

    # -- accounting ---------------------------------------------------------
    def available_blocks(self) -> int:
        """Blocks an admission may still claim: free plus the ref-0
        cached prefix blocks the LRU pass can reclaim, minus
        outstanding reservations. Shared (aliased) blocks count
        exactly once — aliasing a cached prefix consumes no supply."""
        return len(self._free) + self._evictable - self._reserved_total

    def used_blocks(self) -> int:
        """Blocks doing LIVE work — held privately by a slot or
        aliased by at least one (ref > 0). Ref-0 cached prefix blocks
        are NOT used: they are reclaimable supply the LRU pass hands
        back under pressure (``blocks_cached`` counts them)."""
        return self.num_blocks - len(self._free) - self._evictable

    def cached_blocks(self) -> int:
        """Blocks held by the prefix radix tree (shared + ref-0)."""
        return len(self._by_block)

    def occupied_slots(self) -> int:
        """Slots currently holding blocks (private or aliased)."""
        return len(set(self._owned) | set(self._shared))

    def stats(self) -> Dict[str, int]:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "blocks_free": len(self._free),
                "blocks_available": self.available_blocks(),
                "blocks_used": self.used_blocks(),
                "blocks_reserved": self._reserved_total,
                "blocks_cached": len(self._by_block),
                "blocks_evictable": self._evictable,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "evictions": self.evictions}

    def _sync_gauges(self) -> None:
        _G_blocks_free.set(self.available_blocks())
        _G_blocks_used.set(self.used_blocks())

    # -- prefix radix tree (lock held for every _-helper) -------------------
    def _incref(self, node: _PrefixNode) -> None:
        if node.ref == 0:
            self._evictable -= 1
        node.ref += 1

    def _decref(self, node: _PrefixNode) -> None:
        node.ref -= 1
        assert node.ref >= 0, "prefix refcount underflow"
        if node.ref == 0:
            node.stamp = next(self._stamp)
            self._evictable += 1

    def _match_path(self, token_ids) -> List[_PrefixNode]:
        """Walk the tree with consecutive full-block token chunks;
        returns the matched node path (possibly empty)."""
        ids = [int(t) for t in token_ids]
        node, path = self._root, []
        for i in range(len(ids) // self.block_size):
            child = node.children.get(
                tuple(ids[i * self.block_size:(i + 1) * self.block_size]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _evict_one(self) -> Optional[int]:
        """Reclaim the least-recently-released ref-0 LEAF (children
        keep their parent's block reachable; the parent becomes a leaf
        once they go). Returns the freed physical block, or None when
        nothing is evictable."""
        best = None
        for node in self._by_block.values():
            if node.ref == 0 and not node.children and \
                    (best is None or node.stamp < best.stamp):
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        del self._by_block[best.block]
        self._evictable -= 1
        self.evictions += 1
        _M_evictions.inc()
        _flight.record("serving", "prefix_evict", block=best.block,
                       depth_key_tokens=len(best.key))
        return best.block

    def _pop_block(self) -> int:
        """One free block, evicting a cached prefix block if the free
        list is dry. Exhaustion here is a caller bug — every draw is
        covered by an admission-time reservation, and reservations are
        only granted against ``free + evictable``."""
        if self._free:
            return self._free.pop()
        b = self._evict_one()
        if b is None:
            raise RuntimeError(
                "KV block pool over-drawn: no free block and no "
                "evictable cached prefix — a reservation was granted "
                "against supply that no longer exists")
        return b

    # -- allocator ----------------------------------------------------------
    def admit(self, slot: int, prompt_tokens: int,
              total_tokens: int, token_ids=None) -> bool:
        """Admit a request into ``slot``: map blocks for its
        ``prompt_tokens`` now and reserve the rest of its
        ``total_tokens`` worst case. Returns False (request should
        wait) when the pool cannot cover the reservation; raises
        ValueError when it NEVER could (need exceeds the whole pool),
        so an impossible request fails loudly instead of queueing
        forever.

        With ``token_ids`` (the prompt) and the prefix cache on, the
        prompt is first matched against the radix tree: matched blocks
        are ALIASED into the slot's table with refcount bumps and the
        admission charges only the unshared remainder — the caller
        reads ``matched_tokens(slot)`` to skip their prefill. A match
        covering the whole (block-aligned) prompt keeps its last block
        only as a copy-on-write source: prefill must still produce the
        first generated token from position n-1, whose K/V write may
        not land in a shared block — the boundary block is copied at
        admission (one extra charged block; ``take_cow`` hands the
        (src, dst) pair to the engine's device-copy seam) and the
        match is credited as n-1 tokens."""
        slot = int(slot)
        prompt_tokens = int(prompt_tokens)
        now = _ceil_div(max(prompt_tokens, 1), self.block_size)
        total = min(max(_ceil_div(total_tokens, self.block_size), now),
                    self.max_blocks_per_slot)
        with self._lock:
            if total > self.num_blocks:
                raise ValueError(
                    f"request needs {total} KV blocks "
                    f"({total_tokens} tokens at block_size "
                    f"{self.block_size}) but the pool holds only "
                    f"{self.num_blocks}; raise FLAGS_serving_num_blocks "
                    f"or shrink the request")
            if slot in self._owned or slot in self._shared:
                raise ValueError(f"slot {slot} already holds KV blocks")
            path: List[_PrefixNode] = []
            if self.prefix_enabled and token_ids is not None:
                path = self._match_path(token_ids)
            matched = len(path)
            # a full block-aligned match still re-runs the LAST prompt
            # token (its logits seed generation), so the boundary block
            # needs a private copy-on-write clone
            cow = matched > 0 and matched * self.block_size \
                >= prompt_tokens
            # incref BEFORE allocating: the allocation below may evict
            # ref-0 nodes, which must never include our matched path
            for node in path:
                self._incref(node)
            reserved = total - now
            need_now = now - matched + (1 if cow else 0)
            if need_now + reserved > len(self._free) + self._evictable \
                    - self._reserved_total:
                avail = len(self._free) + self._evictable \
                    - self._reserved_total
                for node in path:
                    self._decref(node)
            else:
                blocks = [self._pop_block() for _ in range(need_now)]
                shared = [n.block for n in path]
                if cow:
                    # remap the boundary to its fresh clone; the engine
                    # device-copies src -> dst before any write
                    src = shared.pop()
                    self._decref(path[-1])
                    self._cow_pending[slot] = (src, blocks[0])
                for i, b in enumerate(shared):
                    self.block_tables[slot, i] = b
                for i, b in enumerate(blocks):
                    self.block_tables[slot, len(shared) + i] = b
                self._owned[slot] = list(blocks)
                self._shared[slot] = shared
                self._tail[slot] = path[len(shared) - 1] if shared \
                    else self._root
                skip = (prompt_tokens - 1) if cow \
                    else matched * self.block_size
                self._matched[slot] = skip
                if skip:
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += skip
                self._reserved[slot] = reserved
                self._reserved_total += reserved
                self._sync_gauges()
                avail = None
        if avail is not None:
            _flight.record("serving", "block_exhausted", slot=slot,
                           need=need_now + reserved, available=avail)
            return False
        _flight.record("serving", "block_alloc", slot=slot,
                       blocks=need_now, shared=matched,
                       reserved=total - now,
                       available=self.available_blocks())
        return True

    def matched_tokens(self, slot: int) -> int:
        """Prompt tokens admission matched for ``slot`` — the prefill
        may start at this offset (positions below it are already
        resident in aliased / copied blocks)."""
        return self._matched.get(int(slot), 0)

    def take_cow(self, slot: int) -> Optional[Tuple[int, int]]:
        """Pop the pending boundary copy-on-write ``(src, dst)`` pair
        recorded by ``admit`` (None when the match was not
        block-aligned). The caller MUST device-copy block ``src`` ->
        ``dst`` in every pool leaf before the slot's next write."""
        return self._cow_pending.pop(int(slot), None)

    def cow_for_write(self, slot: int, pos: int) -> \
            Optional[Tuple[int, int]]:
        """Defensive copy-on-write seam for decode/speculative writers:
        if the block covering position ``pos`` of ``slot`` is a SHARED
        prefix block, detach it — allocate a clone, remap the table,
        decref the tree node — and return ``(src, dst)`` for the
        caller's device copy. Returns None on the (universal in
        production) private-block path: admission caps matches below
        the prompt length, so every write position >= len(prompt)
        lands past the shared prefix by construction."""
        slot, pos = int(slot), int(pos)
        shared = self._shared.get(slot)
        if not shared:
            return None
        bidx = pos // self.block_size
        with self._lock:
            shared = self._shared.get(slot)
            if not shared or bidx >= len(shared):
                return None
            if bidx != len(shared) - 1:
                raise RuntimeError(
                    f"write at pos {pos} targets block {bidx} INSIDE "
                    f"slot {slot}'s shared prefix ({len(shared)} "
                    f"blocks) — only the boundary block may be "
                    f"copy-on-written; truncate the slot first")
            src = shared.pop()
            node = self._by_block[src]
            dst = self._pop_block()
            self._decref(node)
            self._tail[slot] = node.parent
            self.block_tables[slot, bidx] = dst
            self._owned.setdefault(slot, []).append(dst)
            self._sync_gauges()
        return src, dst

    def commit_prefix(self, slot: int, token_ids,
                      tokens_written: int) -> int:
        """Publish ``slot``'s fully-written prompt blocks into the
        radix tree (called after each prefill chunk, so hot prefixes
        become matchable while their first writer is still
        prefilling). Only FULL blocks whose every token is already
        written commit — a half-written block must never be aliased.
        Private blocks become tree nodes (ownership transfers, the
        slot keeps an aliased ref); a block whose key already exists
        in the tree dedupes — the slot remaps onto the cached block
        and its private copy returns to the free list. Returns the
        number of blocks committed."""
        if not self.prefix_enabled:
            return 0
        slot = int(slot)
        ids = [int(t) for t in token_ids]
        full = min(int(tokens_written), len(ids)) // self.block_size
        done = 0
        with self._lock:
            shared = self._shared.get(slot)
            owned = self._owned.get(slot)
            if shared is None or owned is None:
                return 0
            tail = self._tail.get(slot, self._root)
            for bidx in range(len(shared), full):
                key = tuple(ids[bidx * self.block_size:
                               (bidx + 1) * self.block_size])
                b = int(self.block_tables[slot, bidx])
                node = tail.children.get(key)
                if node is not None:
                    # dedupe: a concurrent writer (or this slot's own
                    # COW clone) re-created cached content — alias the
                    # tree's block, free the private duplicate
                    self._incref(node)
                    owned.remove(b)
                    self._free.append(b)
                    self.block_tables[slot, bidx] = node.block
                else:
                    if self.prefix_cap and \
                            len(self._by_block) >= self.prefix_cap:
                        freed = self._evict_one()
                        if freed is None:
                            break  # bound hit, nothing reclaimable:
                            # the suffix simply stays private
                        self._free.append(freed)
                    node = _PrefixNode(key, tail, b)
                    tail.children[key] = node
                    node.ref = 1
                    self._by_block[b] = node
                    owned.remove(b)
                shared.append(node.block)
                tail = node
                done += 1
            self._tail[slot] = tail
            if done:
                self._sync_gauges()
        return done

    def reset_prefix_cache(self) -> int:
        """Drop the whole radix tree, returning every cached block to
        the free list — the crash-recovery (`reset_state`) seam: the
        device pools are rebuilt as zeros, so cached content is no
        longer backed by real K/V. Requires every slot released first
        (a live alias would dangle). Returns the blocks reclaimed."""
        with self._lock:
            if any(n.ref for n in self._by_block.values()):
                raise RuntimeError(
                    "reset_prefix_cache with live shared blocks — "
                    "release every slot first (reset_state does)")
            n = len(self._by_block)
            self._free.extend(sorted(self._by_block, reverse=True))
            self._by_block.clear()
            self._root.children.clear()
            self._evictable = 0
            self._shared.clear()
            self._tail.clear()
            self._matched.clear()
            self._cow_pending.clear()
            self._sync_gauges()
        if n:
            _flight.record("serving", "prefix_evict", block=-1,
                           reset=True, blocks=n)
        return n

    def ensure_token(self, slot: int, pos: int) -> None:
        """Map the block covering position ``pos`` of ``slot`` if it
        is not mapped yet, drawing down the slot's admission-time
        reservation (step-boundary extension). A RuntimeError here is
        a caller bug: the budget passed to ``admit`` was too small."""
        slot, pos = int(slot), int(pos)
        bidx = pos // self.block_size
        if bidx >= self.max_blocks_per_slot:
            raise ValueError(
                f"position {pos} is past the cache capacity "
                f"({self.max_blocks_per_slot * self.block_size} tokens)")
        if self.block_tables[slot, bidx] >= 0:
            return
        with self._lock:
            if self.block_tables[slot, bidx] >= 0:
                return  # raced: another thread mapped it first — a
                # double-pop here would orphan a block AND over-draw
                # the reservation (the check above is lock-free)
            if self._reserved.get(slot, 0) <= 0:
                raise RuntimeError(
                    f"slot {slot} has no KV reservation left at pos "
                    f"{pos} — the generation budget passed at admission "
                    f"was too small")
            b = self._pop_block()
            self._reserved[slot] -= 1
            self._reserved_total -= 1
            self._owned[slot].append(b)
            self.block_tables[slot, bidx] = b
            self._sync_gauges()
        _flight.record("serving", "block_alloc", slot=slot, blocks=1,
                       block_index=bidx,
                       available=self.available_blocks())

    def reserve_through(self, slot: int, pos: int) -> None:
        """Materialize every block covering positions [0, pos] — the
        decode-window pre-extension (``decode_steps`` needs a block
        table that stays valid for the whole device-resident loop)."""
        last = min(int(pos) // self.block_size,
                   self.max_blocks_per_slot - 1)
        for bidx in range(last + 1):
            if self.block_tables[int(slot), bidx] < 0:
                self.ensure_token(slot, bidx * self.block_size)

    def truncate(self, slot: int, tokens: int) -> int:
        """Roll back ``slot``'s mapping to its first ``tokens``
        positions: blocks past the last kept position are returned to
        the free list and RE-CREDITED to the slot's reservation — the
        speculative-decode rollback seam (a rejected draft's tokens
        are just extra block writes; un-mapping them restores the
        admission-time budget so the next window's pre-extension can
        draw the same blocks again). Returns the block count rolled
        back."""
        slot, tokens = int(slot), int(tokens)
        keep = _ceil_div(tokens, self.block_size) if tokens > 0 else 0
        rolled = unshared = 0
        with self._lock:
            owned = self._owned.get(slot)
            if owned is None:
                return 0
            shared = self._shared.get(slot, [])
            if keep < len(shared):
                # rolling back INTO the shared prefix (never the spec
                # path — committed streams cover the whole prompt —
                # but direct truncate may): decref, don't free, and do
                # NOT re-credit the reservation (aliased blocks were
                # never charged against it)
                for b in shared[keep:]:
                    self._decref(self._by_block[b])
                    unshared += 1
                self.block_tables[slot, keep:len(shared)] = -1
                del shared[keep:]
                tail = self._root
                for b in shared:
                    tail = self._by_block[b]
                self._tail[slot] = tail
                self._matched[slot] = min(
                    self._matched.get(slot, 0),
                    keep * self.block_size)
            for bidx in range(max(keep, len(shared)),
                              self.max_blocks_per_slot):
                b = int(self.block_tables[slot, bidx])
                if b < 0:
                    continue
                self.block_tables[slot, bidx] = -1
                owned.remove(b)
                self._free.append(b)
                rolled += 1
            if rolled:
                # invariant preserved: free and reserved_total grow by
                # the same amount, so free >= reserved_total still holds
                self._reserved[slot] = self._reserved.get(slot, 0) \
                    + rolled
                self._reserved_total += rolled
            if rolled or unshared:
                self._sync_gauges()
        if rolled or unshared:
            _flight.record("serving", "block_rollback", slot=slot,
                           blocks=rolled, unshared=unshared,
                           kept_tokens=tokens,
                           available=self.available_blocks())
        return rolled

    def release(self, slot: int, evicted: bool = False) -> int:
        """Return all of ``slot``'s private blocks, decref its shared
        prefix (the tree KEEPS those blocks cached at ref 0, where
        they stay matchable until LRU pressure reclaims them) and
        cancel its reservation. ``evicted=True`` marks a reclaim
        (deadline expiry, failure, cancellation) and bumps
        ``serving.block_evictions_total`` for the private blocks;
        normal completion leaves the counter alone."""
        slot = int(slot)
        with self._lock:
            blocks = self._owned.pop(slot, [])
            shared = self._shared.pop(slot, [])
            for b in shared:
                self._decref(self._by_block[b])
            self._tail.pop(slot, None)
            self._matched.pop(slot, None)
            self._cow_pending.pop(slot, None)
            resv = self._reserved.pop(slot, 0)
            self._reserved_total -= resv
            self._free.extend(blocks)
            self.block_tables[slot, :] = -1
            if evicted and blocks:
                self.evictions += len(blocks)
            self._sync_gauges()
        if evicted and blocks:
            _M_evictions.inc(len(blocks))
        if blocks or shared or resv:
            _flight.record("serving", "block_free", slot=slot,
                           blocks=len(blocks), unshared=len(shared),
                           evicted=bool(evicted),
                           available=self.available_blocks())
        return len(blocks)

    def check_invariants(self) -> None:
        """Assert the allocator's global invariants (the tests'
        step-boundary probe; not on any hot path):

        - free / privately-owned / tree blocks PARTITION the pool;
        - every node's refcount equals the number of slots aliasing
          its block, and never exceeds its parent's;
        - the evictable count equals the ref-0 node count;
        - each slot's shared blocks are a contiguous table prefix;
        - ``free + evictable - reserved_total >= 0`` (reservations
          can always be honored without touching a live block).
        """
        with self._lock:
            free = list(self._free)
            owned_all = [b for bs in self._owned.values() for b in bs]
            tree = list(self._by_block)
            assert len(set(free)) == len(free), "free-list duplicates"
            assert len(set(owned_all)) == len(owned_all), \
                "block owned by two slots"
            union = free + owned_all + tree
            assert sorted(union) == list(range(self.num_blocks)), (
                f"pool partition broken: free={sorted(free)} "
                f"owned={sorted(owned_all)} tree={sorted(tree)}")
            want_ref: Dict[int, int] = {}
            for slot, shared in self._shared.items():
                for i, b in enumerate(shared):
                    assert int(self.block_tables[slot, i]) == b, \
                        f"slot {slot} shared prefix not contiguous"
                    want_ref[b] = want_ref.get(b, 0) + 1
            zero = 0
            for b, node in self._by_block.items():
                assert node.block == b
                assert node.ref == want_ref.get(b, 0), (
                    f"block {b}: ref {node.ref} != "
                    f"{want_ref.get(b, 0)} aliasing slots")
                assert node.parent is self._root \
                    or node.parent.ref >= node.ref, \
                    f"block {b}: child outrefs its parent"
                zero += node.ref == 0
            assert zero == self._evictable, \
                f"evictable count {self._evictable} != {zero} ref-0 nodes"
            assert self._reserved_total == sum(self._reserved.values())
            assert len(free) + zero - self._reserved_total >= 0, (
                f"reservation invariant broken: free={len(free)} "
                f"evictable={zero} reserved={self._reserved_total}")

    def active_tokens(self, pos: np.ndarray,
                      active: np.ndarray) -> int:
        """Tokens currently resident across active slots (the paged
        roofline's cache-traffic term: O(active tokens), not
        O(slots x max_seq))."""
        return int(sum(int(p) for p, a in zip(pos, active) if a))


# ---------------------------------------------------------------------------
# device side: block writes + the paged-attention seam
# ---------------------------------------------------------------------------

def absmax_quantize(x: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) absmax int8 of K/V rows
    ``[N, KVH, D]`` -> ``(codes int8 [N, KVH, D], scale f32 [N, KVH])``:
    dynamic absmax over the head dim, qmax = 2^(bits-1) - 1. The pool
    stores the codes; the attention tiles dequantize on load."""
    qmax = float(2 ** (bits - 1) - 1)
    a = x.float()
    scale = a.abs().amax(dim=-1).clamp(min=1e-8) / qmax
    codes = torch.round(a / scale[..., None]).clamp(-qmax, qmax)
    return codes.to(torch.int8), scale


def copy_block(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy one whole physical block (all ``block_size`` rows)
    ``pool[src] -> pool[dst]`` IN PLACE — the copy-on-write data move.
    Returns ``pool``."""
    pool[int(dst)].copy_(pool[int(src)])
    return pool


def kv_write_rows(positions: torch.Tensor, tables: torch.Tensor,
                  wmask: torch.Tensor, block_size: int,
                  num_blocks: int) -> torch.Tensor:
    """The DEVICE write plan of one step, with fixed shapes and no host
    sync: the flat row, in a pool STORE ``[num_blocks + 1, block_size,
    ...]`` viewed as ``[(num_blocks + 1) * block_size, ...]``, of each
    K/V row at ``positions [S, T]`` — the JAX ``_write_kv`` cells
    (``take_along_axis`` of the block tables at ``min(pos // bs, MB -
    1)``, offset ``pos % bs``). Rows with ``wmask`` False or an unmapped
    (``< 0``) table entry go to row ``num_blocks * block_size``, the
    first row of the store's SINK block, which no table maps: they land
    nowhere a walk reads, and never on a cell a live row of the same
    step writes (clamping would). Returns int64 ``[S * T]``."""
    bs = int(block_size)
    bidx = torch.clamp(positions // bs, max=tables.shape[1] - 1).long()
    phys = torch.take_along_dim(tables, bidx, dim=1).long()
    ok = wmask & (phys >= 0)
    rows = torch.where(ok, phys * bs + positions % bs,
                       int(num_blocks) * bs)
    return rows.reshape(-1)


def write_kv_rows(store: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals [N, ...]`` into the flat rows ``rows [N]`` of a pool
    store (:func:`kv_write_rows`) IN PLACE, cast to its dtype. Returns
    ``store``."""
    flat = store.view((-1,) + tuple(store.shape[2:]))
    flat.index_put_((rows,), vals.to(store.dtype))
    return store


def copy_block_device(store: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
    """:func:`copy_block` with the block ids as one-element device
    tensors (what a captured copy-on-write program reads), IN PLACE."""
    store.index_copy_(0, dst.reshape(1).long(),
                      store.index_select(0, src.reshape(1).long()))
    return store


class KVWritePlan(NamedTuple):
    """Device index tensors of one step's K/V row writes, with the
    dropped rows already filtered out: ``rows`` selects the written
    rows of the flat ``[N, ...]`` values, ``phys``/``off`` are their
    (physical block, offset) cells."""
    rows: torch.Tensor
    phys: torch.Tensor
    off: torch.Tensor


def plan_kv_writes(phys, off, num_blocks: int,
                   device: torch.device) -> KVWritePlan:
    """Filter writes ON THE HOST — rows whose ``phys`` is out of range
    (callers map invalid rows to ``num_blocks``, as the JAX package
    does) are dropped — and move the survivors' indices to ``device``
    once. For host callers (:func:`write_kv_tokens`); the engines plan
    on the card (:func:`kv_write_rows`). An out-of-range ``index_put_``
    would be an IndexError on the CPU and a device-side assert on the
    card, so the filter comes first."""
    phys = np.asarray(phys, np.int64).reshape(-1)
    off = np.asarray(off, np.int64).reshape(-1)
    keep = np.nonzero((phys >= 0) & (phys < int(num_blocks)))[0]
    return KVWritePlan(*(torch.as_tensor(a).to(device)
                         for a in (keep, phys[keep], off[keep])))


def scatter_kv(pool: torch.Tensor, plan: KVWritePlan,
               vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals [N, ...]`` rows ``plan.rows`` into their cells of
    ``pool`` IN PLACE (cast to the pool's dtype). Returns ``pool``."""
    pool.index_put_((plan.phys, plan.off),
                    vals.index_select(0, plan.rows).to(pool.dtype))
    return pool


def write_kv_tokens(pool: torch.Tensor, phys, off,
                    vals: torch.Tensor) -> torch.Tensor:
    """Scatter ``vals [N, ...]`` into ``pool[phys[i], off[i]]`` IN
    PLACE; rows whose ``phys`` is out of range (the caller maps
    invalid rows to ``num_blocks``) are dropped, so padded prefill rows
    and inactive decode slots never touch a real block. ``phys``/``off``
    are host indices (numpy or CPU tensors). Returns ``pool``."""
    if isinstance(phys, torch.Tensor):
        phys = phys.cpu().numpy()
    if isinstance(off, torch.Tensor):
        off = off.cpu().numpy()
    plan = plan_kv_writes(phys, off, pool.shape[0], pool.device)
    return scatter_kv(pool, plan, vals)


def use_kernel_default() -> bool:
    """``FLAGS_paged_attention_kernel``: whether engines on the card
    run the Hopper kernel behind the seam. An engine on the card that
    finds it off raises instead of switching to the plain walk."""
    from .core.flags import flag_value
    return bool(flag_value("paged_attention_kernel"))


def paged_attention(q, k_pool, v_pool, tables, positions, *,
                    block_size: int, n_rep: int, n_tiles=None,
                    k_scale=None, v_scale=None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Block-table paged attention for one layer: ``q [S, T, H, D]``
    attends the K/V history of its slot, stored as pool blocks
    ``[num_blocks, block_size, KVH, D]`` addressed through
    ``tables [S, max_blocks]`` (entry < 0 = unmapped). Row ``(s, t)``
    attends every column ``c <= positions[s, t]``; ``n_rep = H // KVH``
    query heads share each KV head; ``k_scale/v_scale`` switch to
    int8-dequant mode; tiles at or past ``n_tiles`` are skipped.

    ``use_kernel`` selects the implementation behind this ONE seam:
    None (default) and True go to the kernel wrapper, which launches
    the Hopper kernel for CUDA tensors (or raises) and takes the plain
    walk for CPU tensors; False asks for the plain walk by name, on
    either device — the oracle the kernel is held against."""
    fn = _pk.paged_attention_reference if use_kernel is False \
        else _pk.paged_attention_kernel
    return fn(q, k_pool, v_pool, tables, positions, block_size=block_size,
              n_rep=n_rep, n_tiles=n_tiles, k_scale=k_scale,
              v_scale=v_scale)

"""Runtime flag registry.

The port's own copy of ``paddle_tpu.core.flags``: flags are declared
with a type + default, overridable from the environment as
``FLAGS_<name>`` and at runtime via :func:`set_flags`. It keeps the
JAX package's flag names and defaults, so one environment configures
both packages, and it defines only the flags this package reads. There
is no native mirror of the registry.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["define_flag", "flag_value", "get_flags", "set_flags"]

_BOOL_TRUE = {"1", "true", "yes", "on"}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in _BOOL_TRUE


@dataclass
class _FlagInfo:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str
    value: Any = None


_registry: Dict[str, _FlagInfo] = {}


def define_flag(name: str, default: Any, help: str = "") -> None:
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    info = _FlagInfo(name, default, parser, help, default)
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        info.value = parser(env)
    _registry[name] = info


def _key(flag: str) -> str:
    key = flag[len("FLAGS_"):] if flag.startswith("FLAGS_") else flag
    if key not in _registry:
        raise ValueError(f"Unknown flag {flag}")
    return key


def get_flags(flags):
    """get_flags('FLAGS_x') or get_flags(['FLAGS_x', ...]) -> dict"""
    if isinstance(flags, str):
        flags = [flags]
    return {f: _registry[_key(f)].value for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    for f, v in flags.items():
        info = _registry[_key(f)]
        info.value = info.parser(v) if isinstance(v, str) else v


def flag_value(name: str):
    return _registry[name].value


define_flag("serving_block_size", 16,
            "Tokens per KV block in the paged serving cache "
            "(serving.PagedLlamaDecodeEngine): the block pool is "
            "[num_blocks, block_size, KVH, D] per layer")
define_flag("serving_num_blocks", 0,
            "KV blocks in the paged serving pool, shared by all slots. "
            "0 (default) = auto-size to dense capacity parity "
            "(max_slots x ceil(max_seq/block_size))")
define_flag("serving_prefill_chunk", 64,
            "Max prompt tokens a single paged prefill call processes: "
            "the GenerationServer loop interleaves one chunk with each "
            "decode step")
define_flag("serving_prefix_cache", True,
            "Content-addressed prefix sharing in the paged KV cache "
            "(radix tree over committed prompt blocks); 0 = private "
            "blocks only")
define_flag("serving_prefix_cache_blocks", 0,
            "Upper bound on KV blocks the prefix radix tree may hold; "
            "0 (default) = unbounded within the pool")
define_flag("serving_shed_queue", 0,
            "Load-shedding queue bound for the paged GenerationServer: "
            "with no available KV blocks AND more than this many "
            "requests deferred, submit() rejects (reason=shed). "
            "0 (default) disables shedding")
define_flag("serving_spec_tokens", 4,
            "Draft tokens a speculative decode step proposes per "
            "target step (the speculation window). The target model "
            "verifies the whole window in ONE batched paged-attention "
            "call and commits the accepted prefix; greedy output is "
            "bit-equal to the non-speculative stream regardless of "
            "the window size — this only trades draft work against "
            "acceptance length")
define_flag("serving_spec_draft_layers", 0,
            "Decoder layers in the auto-built truncated-layer draft "
            "model (PagedLlamaDecodeEngine.make_draft): the draft "
            "shares the target's embedding/head/first-N-layer weights "
            "at zero extra weight memory. 0 (default) = half the "
            "target's layers (min 1)")
define_flag("serving_admission_policy", "static",
            "Admission policy a GenerationServer builds when none is "
            "passed: 'static' keeps the FLAGS_serving_shed_queue rule "
            "(the fallback policy), 'adaptive' installs "
            "serving_supervisor.AdaptiveAdmissionPolicy — "
            "step-boundary EWMAs of blocks_free/backlog/throughput "
            "driving graceful brownout (speculative window, then "
            "prefill chunk) before hard shedding, plus deadline-aware "
            "rejection at submit")
define_flag("serving_fleet_heartbeat_seconds", 0.5,
            "Fleet router heartbeat period: every replica's /health "
            "RPC is probed this often on a dedicated short-timeout "
            "connection, and the returned gauges (blocks_free, "
            "backlog, admission pressure level) feed KV-pressure-"
            "aware placement")
define_flag("serving_fleet_heartbeat_misses", 3,
            "Consecutive failed heartbeats before the fleet router "
            "declares a replica dead: its epoch is fenced (late "
            "responses discarded), in-flight requests fail over to "
            "healthy replicas seeded with their committed tokens, "
            "and resurrection begins. A data-plane connection error "
            "fences immediately without waiting for misses")
define_flag("serving_fleet_restart_backoff", 0.05,
            "Base seconds of the fleet router's bounded exponential "
            "resurrection backoff: relaunch attempt N of a dead "
            "replica waits backoff * 2^(N-1) (capped, full-jittered "
            "under FLAGS_backoff_full_jitter) before spawning the "
            "replacement process from the shared executable cache + "
            "warm bundle")
define_flag("serving_fleet_max_restarts", 8,
            "Resurrection attempts per dead replica before the fleet "
            "router gives up on it and degrades to the surviving "
            "replicas (the router itself never crashes; a degraded "
            "slot is journaled and counted)")
define_flag("serving_fleet_retry_after", 1.0,
            "Seconds clients are told to wait (the retry_after hint "
            "on the fleet-shed error) when every live replica reports "
            "admission pressure level 3 — fleet-level shed fires only "
            "after per-replica brownout has already been exhausted "
            "everywhere")
define_flag("paged_attention_kernel", True,
            "Run the hand-written paged-attention kernel behind the "
            "serving_cache.paged_attention seam for CUDA tensors. On a "
            "CUDA engine 0 raises: the plain walk runs on the card only "
            "when asked for by name (attention_impl='reference')")
define_flag("fused_optimizer", True,
            "One fused optimizer step: Adam and AdamW update every "
            "parameter in one multi-tensor pass on the card (the "
            "hand-written kernels of ops/kernels/multi_tensor.py), with "
            "gradient clipping, the AMP unscale and finite check and the "
            "skip of a non-finite step inside it; lr and the loss scale "
            "stay in device memory. Kill switch: FLAGS_fused_optimizer=0 "
            "restores the per-parameter update loop")
define_flag("serving_supervisor_backoff", 0.05,
            "Base seconds of the ServingSupervisor's bounded "
            "exponential restart backoff: death N of a streak waits "
            "backoff * 2^(N-1), capped; the streak resets after a "
            "healthy stretch")
define_flag("serving_supervisor_stall_seconds", 0.0,
            "Decode-loop stall watchdog: a loop thread that is alive "
            "but has not heartbeat for this many seconds WHILE "
            "holding work is fenced and restarted like a crash (0 = "
            "stall detection off; an idle loop parked on the empty "
            "queue never counts as stalled)")
define_flag("backoff_full_jitter", True,
            "Full jitter on every bounded-exponential backoff (supervisor "
            "restarts, TCPStore retries, fleet replica resurrection): sleep "
            "uniform(0, bound) instead of the deterministic bound, so "
            "correlated failures do not synchronize retriers into a "
            "stampede. 0 restores the deterministic schedule; "
            "utils.backoff.seed(n) makes the jittered draws reproducible "
            "for tests")
define_flag("flight_recorder", True,
            "Always-on black-box event journal (observability.flight): a "
            "fixed-capacity ring of structured events (fusion flushes, host "
            "syncs, collectives, checkpoint/elastic/serving lifecycle) "
            "dumped as crash forensics on unhandled exceptions, watchdog "
            "timeouts, signals or flight.dump(). 0 disables recording "
            "(dump() still writes whatever the ring holds)")
define_flag("flight_recorder_capacity", 4096,
            "Event capacity of the flight-recorder ring; the oldest events "
            "are evicted first (a dump carries the LAST N events)")
define_flag("flight_dump_dir", "",
            "Directory flight-recorder dumps are written to; empty "
            "(default) uses the system temp dir")
define_flag("checkpoint_fsync", True,
            "fsync checkpoint temp files (and their directory) before "
            "the atomic rename. Durability contract against power loss; "
            "disable only in tests/benchmarks on throwaway dirs")

"""Fleet serving: readiness of one replica.

For now this module holds only :func:`health_snapshot`, the readiness
dict that ``GenerationServer.metrics_endpoint`` serves at ``/healthz``
(the port's copy of ``paddle_tpu.serving_fleet.health_snapshot``). The
fleet router, the replica servers and their wire protocol come with
the fleet planes (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import os

__all__ = ["health_snapshot"]


def health_snapshot(server) -> dict:
    """Readiness + placement evidence for one ``GenerationServer``
    (duck-typed). ``ok`` means "will productively take traffic": decode
    loop alive, supervisor not given up, not draining, admission below
    hard shed."""
    thread = getattr(server, "_thread", None)
    loop_alive = bool(thread is not None and thread.is_alive()
                      and not getattr(server, "_crashed", False))
    sup = getattr(server, "_supervisor", None)
    gave_up = bool(getattr(sup, "gave_up", False))
    level = int(getattr(server.policy, "level", 0))
    paged = bool(getattr(server, "_paged", False))
    if paged:
        kv = server.engine._kv
        blocks_free, blocks_total = int(kv.available_blocks()), \
            int(kv.num_blocks)
    else:
        blocks_free = blocks_total = -1  # dense engine: no pool gauge
    backlog = int(server._q.qsize() + len(server._waiting))
    draining = bool(server._stopping.is_set())
    ok = loop_alive and not gave_up and not draining and level < 3
    return {"ok": ok, "loop_alive": loop_alive, "gave_up": gave_up,
            "level": level, "blocks_free": blocks_free,
            "blocks_total": blocks_total, "backlog": backlog,
            "in_flight": len(server._slots),
            "draining": draining, "pid": os.getpid()}

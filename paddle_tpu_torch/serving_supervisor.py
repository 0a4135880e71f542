"""Admission policies for the GenerationServer.

The port carries the static policy only: :class:`StaticShedPolicy` and
:func:`default_policy`. The adaptive brownout policy, the loop
supervisor and canary ``rollout`` of ``paddle_tpu.serving_supervisor``
come with a later slice.
"""
from __future__ import annotations

from typing import List, Optional

from .core.flags import flag_value

__all__ = ["StaticShedPolicy", "default_policy"]


class StaticShedPolicy:
    """Shed exactly when ``GenerationServer._shed()`` says so
    (block-starved AND the backlog over ``FLAGS_serving_shed_queue``;
    0 disables). No brownout, no deadline awareness."""

    name = "static"

    def on_step(self, server) -> None:  # no step-boundary state
        return None

    def admit_verdict(self, server, prompt_len: int, max_new: int,
                      deadline: Optional[float]) -> Optional[str]:
        return "shed" if server._shed() else None

    def journal(self) -> List[dict]:
        return []


def default_policy():
    """The policy ``GenerationServer`` installs when none is passed:
    ``FLAGS_serving_admission_policy``. Only 'static' is ported; asking
    for 'adaptive' raises rather than silently serving without it."""
    name = str(flag_value("serving_admission_policy")).strip()
    if name == "adaptive":
        raise NotImplementedError(
            "the adaptive admission policy is not ported yet; set "
            "FLAGS_serving_admission_policy=static")
    return StaticShedPolicy()

"""Utilities of the port: gradient clipping and the general helpers
(``deprecated``, ``run_check``, ``require_version``, ``try_import``)."""
from . import clip_grad  # noqa: F401
from .helpers import (  # noqa: F401
    deprecated, require_version, run_check, try_import)

__all__ = ["deprecated", "run_check", "require_version", "try_import"]

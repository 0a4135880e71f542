"""The port's native runtime: ``native.cpp`` (the host tracer) built
with ``g++`` into a CPython extension at first use.

The counterpart of ``paddle_tpu._native``, with its own copy of the
source. The library goes into the kernels' build directory
(``ops.kernels.build.build_dir()``: ``FLAGS_executable_cache_dir``, else
``$PADDLE_TPU_TORCH_KERNEL_DIR``, else the git-ignored
``ops/kernels/_build/``), never beside the source. Its file name carries
a hash of the source, the compiler flags and the Python ABI, so an
edited source rebuilds. The build is atomic: ``g++`` writes a temporary
file that ``os.replace`` moves into place, under an exclusive file lock,
so processes that build at once (test workers) load one library.

:func:`lib` builds and loads it and raises with the compiler's tail
when it cannot: what needs the native runtime (``paddle.profiler``)
does not run without it. :func:`loaded` returns the module only when
some caller already loaded it (``RecordEvent`` outside a profiler
builds nothing).
"""
from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional

__all__ = ["lib", "loaded", "library_path", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "native.cpp"
MODULE = "_paddle_torch_native"

_lock = threading.Lock()
_lib = None


def _command(out: Path):
    include = sysconfig.get_paths()["include"]
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{include}", str(SOURCE), "-o", str(out), "-lpthread"]


def library_path() -> Path:
    """Where the library for this source, these flags and this Python
    lives (built or not)."""
    from ..ops.kernels.build import build_dir
    tag = hashlib.sha256()
    tag.update(SOURCE.read_bytes())
    tag.update(" ".join(_command(Path("x"))).encode())
    tag.update(sysconfig.get_config_var("SOABI").encode()
               if sysconfig.get_config_var("SOABI") else b"")
    return build_dir() / f"{MODULE}-{tag.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(_command(tmp), capture_output=True,
                                      text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(
                    f"paddle_tpu_torch._native: g++ did not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"paddle_tpu_torch._native: the build of {SOURCE.name} "
                    f"failed (exit {proc.returncode}):\n"
                    f"{(proc.stderr or proc.stdout)[-3000:]}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def lib():
    """The native module, built at the first call in a process."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            spec = importlib.util.spec_from_file_location(MODULE, so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules.setdefault(MODULE, mod)
            _lib = mod
        return _lib


def loaded() -> Optional[object]:
    """The module when it is loaded, else None (builds nothing)."""
    return _lib

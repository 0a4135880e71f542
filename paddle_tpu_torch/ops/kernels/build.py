"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface for ``sm_90a`` (Hopper), loaded with
``ctypes``. The build runs at first use — never at import — into
``_build/`` beside this file (git-ignored; the environment variable
``PADDLE_TPU_TORCH_KERNEL_DIR`` moves it). Each library's file name
carries a hash of its source, the shared headers and the compiler
flags, so an edited source rebuilds and an unchanged one loads from
disk. Sources that need building compile in parallel: one ``nvcc``
process each, all started together.

The directory of built libraries is the port's executable cache: what
a warm process skips is ``nvcc``. ``FLAGS_executable_cache_dir``
(``jit.warmup``), when set, names it, and while it is set the counters
``executable_cache.{hits,misses,writes}_total`` count a library loaded
from disk, an ``nvcc`` run and a library written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from ...jit import warmup as _warmup

__all__ = ["BuildInfo", "build_all", "build_dir", "load", "nvcc_command",
           "nvcc_path", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR_ENV = "PADDLE_TPU_TORCH_KERNEL_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildInfo:
    """One source's build: the library path, the seconds ``nvcc`` took
    (0.0 when the library was already on disk) and its output (the
    ``-Xptxas -v`` register/shared-memory report with ``verbose``)."""
    name: str
    path: Path
    seconds: float
    log: str


def build_dir() -> Path:
    """``FLAGS_executable_cache_dir`` when set, else
    ``$PADDLE_TPU_TORCH_KERNEL_DIR``, else ``_build/`` beside this
    file."""
    d = _warmup.cache_dir() or os.environ.get(BUILD_DIR_ENV)
    return Path(d) if d else Path(__file__).resolve().parent / "_build"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default location. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _library(src: Path) -> Path:
    return build_dir() / f"lib{src.stem}_{_digest(src)}.so"


def nvcc_command(src: Path, out: Path, verbose: bool = False) -> List[str]:
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(src)]


def build_all(verbose: bool = False) -> Dict[str, BuildInfo]:
    """Build every source whose library is missing, all ``nvcc``
    processes at once; returns ``{source stem: BuildInfo}``. Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    out: Dict[str, BuildInfo] = {}
    todo = []
    for src in sources():
        lib = _library(src)
        if lib.exists() and not verbose:
            out[src.stem] = BuildInfo(src.stem, lib, 0.0, "")
        else:
            todo.append((src, lib))
    if todo:
        nvcc_path()  # fail before touching the disk
        build_dir().mkdir(parents=True, exist_ok=True)
    _warmup.count_cache("misses", len(todo))
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(src, tmp, verbose),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, lib, tmp, proc, time.perf_counter()))
    failed = []
    for src, lib, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)  # atomic: concurrent builds race safely
        _warmup.count_cache("writes")
        out[src.stem] = BuildInfo(src.stem, lib, dt, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel
    first if its library is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(f"no kernel source {src}")
            path = _library(src)
            if path.exists():
                _warmup.count_cache("hits")
            else:
                path = build_all()[name].path
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Builds happen at first use, into
``src/repro_torch/build/`` (ignored by git); the library's file name carries
a hash of its source and flags, so an edited source is never served from a
stale build. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def sources() -> list:
    """Kernel source names (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}.{digest[:12]}.so"


def _start_build(name: str):
    """(Popen or None, target path, log path): None when already built."""
    target = library_path(name)
    if target.exists():
        return None, target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, target, log


def _finish_build(proc, target: Path, log: Path) -> None:
    if proc is None:
        return
    rc = proc.wait()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}) for {target.name}:\n"
                           + log.read_text())
    os.replace(tmp, target)


def build_all() -> dict:
    """Compile every source that has no current build, one ``nvcc`` per
    source started together. -> {name: nvcc log text ('' when cached)}."""
    started = {name: _start_build(name) for name in sources()}
    logs = {}
    for name, (proc, target, log) in started.items():
        _finish_build(proc, target, log)
        logs[name] = log.read_text() if log is not None else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish_build(*_start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib

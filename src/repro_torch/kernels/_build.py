"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Builds happen at first use, into
``src/repro_torch/build/`` (ignored by git); the library's file name carries
a hash of its source, of every shared header (``csrc/*.cuh``) and of the
flags, so an edited source or header is never served from a stale build.
``build_all`` starts one ``nvcc`` per source, all at once; ``launch`` calls
a built kernel through its plain C interface.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

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
    """Build target of ``csrc/<name>.cu``; its name carries a digest of the
    source, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha1()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:12]}.so"


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


_SMS: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` names, read once per
    card and cached (no sync: a property query, safe inside a graph
    capture once cached)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def float_bits(x: float) -> int:
    """The float32 bits of ``x`` as a signed int: how a float crosses the
    plain C interface, which passes ints."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def launch(name: str, device, pointers, ints, *, entry: str = None) -> None:
    """Call ``<name>_launch`` (``<name>_<entry>_launch`` when ``entry`` is
    given: a second kernel of the same source) of ``csrc/<name>.cu`` on the
    current stream of ``device``: the device pointers, then the ints, then
    the stream (the plain C interface every kernel source exports). Raises
    RuntimeError with CUDA's message when the launch is refused."""
    lib = load(name)
    fn = getattr(lib, f"{name}_{entry}_launch" if entry else f"{name}_launch")
    msg = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:        # argtypes last: it marks the binding done
        p, i = ctypes.c_void_p, ctypes.c_int
        msg.argtypes, msg.restype = [i], ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * len(pointers) + [i] * len(ints) + [p]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*pointers, *ints, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: " + msg(err).decode())

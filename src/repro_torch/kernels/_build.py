"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface.  At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/repro_torch_kernels/`` at the repository root, named
by a hash of its source, the headers it includes (``HEADERS``) and the
flags (an edited source or header rebuilds, an unchanged one is reused),
and loaded with ``ctypes``.  Pointers and the CUDA stream
cross the boundary as ``c_void_p``; each C entry returns
``cudaGetLastError()`` after its launch and :func:`check` raises on a
nonzero code.  Nothing here falls back to the CPU: a missing ``nvcc``, a
failed build or a failed launch raises.

The launch counts (``launches``) let a run show that its main path went
through the kernels: every wrapper adds one where it launches its kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rmsnorm", "paged_attention", "flash_attention",
           "fused_adamw", "quantize", "ssd", "ring_attention")
# headers a source includes: part of its hash, so an edit rebuilds it
HEADERS = {"paged_attention": ("split_combine.cuh",),
           "ring_attention": ("split_combine.cuh",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels are compiled at first use and need the CUDA "
        "toolkit; CPU tensors take the plain PyTorch versions instead")


def _lib_path(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes()
                   for f in (f"{name}.cu", *HEADERS.get(name, ())))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> str:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Raises on the
    first failure.  Returns the compilers' combined output (register and
    shared-memory use per kernel when ``verbose``)."""
    todo = [n for n in (names or SOURCES) if not _lib_path(n).exists()]
    if not todo:
        return ""
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== nvcc {name}.cu (rc {proc.returncode})\n{text}")
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    return log


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed),
    with ``argtypes`` set from ``signatures`` (function -> argtypes; every
    function returns a CUDA error code as int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")

"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``ops/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``ops/_build/`` (listed in ``.gitignore``).  A library's sources are its
``.cu`` file and the headers it includes (``hopper.cuh``): nvcc compiles
the ``.cu`` files, with ``-I`` for ``csrc/``, and the library's file name
carries a hash of every listed source and the flags, so an edited source
or header rebuilds and an unchanged one is reused.  Nothing here runs at
import: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v", f"-I{CSRC}"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register/spill report and nvcc wall seconds of the last build of
# each library.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                       "first use and need the CUDA toolkit")


def library_path(name: str, sources: List[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(name: str, sources: List[str]) -> Path:
    """Compile the ``.cu`` files of ``sources`` (names under ``csrc/``;
    the headers among them only enter the hash) into
    ``_build/lib<name>_<hash>.so`` unless it exists.  Raises with the
    compiler's output on failure.  Safe to call from several threads or
    processes at once: each nvcc writes its own temporary file."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def load(name: str, sources: List[str],
         signatures: Optional[Dict[str, tuple]] = None) -> ctypes.CDLL:
    """Build if needed, then load once per process.  ``signatures``
    maps a C function to ``(restype, [argtypes])``: pointers and the
    stream must be ``c_void_p`` or ctypes cuts them to 32 bits."""
    lib = _libs.get(name)  # loaded: no lock on the launch path
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            for fn, (restype, argtypes) in (signatures or {}).items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return lib

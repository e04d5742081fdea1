"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/kernels/
libpbd_torch_kernels.so`` beside the package, and loaded with
``ctypes``.  The sources include no PyTorch header, so a build takes
seconds.  The library is rebuilt when the content of a source or the
flags change.  A build failure raises; nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libpbd_torch_kernels.so"
# --fmad=false: no multiply-add contraction, so every kernel rounds each
# operation the way the plain PyTorch version does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name -> (argtypes, restype)
SIGNATURES = {
    "pbd_walk_tree": ([_P] * 13 + [_I] * 8 + [_P], _I),
    "pbd_chase": ([_P, _I, _P, _P], _I),
    "pbd_dp_tree": ([_P] * 8 + [_I] * 5 + [_P], _I),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")]
                  if cuda_home else []) + ["/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Tuple[Path, str]:
    """Compile the kernels if the library is missing or stale.  Returns
    (library path, compiler log — ptxas register and spill counts; empty
    when the library was up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sources)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(tmp)]
        + [str(src) for src in sources],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the kernel sources:\n"
                           + proc.stdout)
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, proc.stdout


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures
    declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib

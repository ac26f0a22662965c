"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``osqp_tpu_torch/csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, which ``ctypes`` loads. The library
goes to ``osqp_tpu_torch/.build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the sources, so an edited source is rebuilt and an
unchanged one is built once per checkout, at its first CUDA use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "solve_kernel.cu",)
BUILD_DIR = _PKG / ".build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"osqp_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless this source hash is already built.
    Returns (library path, compiler output; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, *map(str, _SOURCES)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    f = lib.osqp_admm_solve_shared
    f.restype = i
    f.argtypes = ([i, i] + [vp] * 26 + [i] * 5 + [d, d, i, i]
                  + [d] * 6 + [i, vp])
    lib.osqp_cuda_error_string.restype = ctypes.c_char_p
    lib.osqp_cuda_error_string.argtypes = [i]
    return lib

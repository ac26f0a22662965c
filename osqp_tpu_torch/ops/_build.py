"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``osqp_tpu_torch/csrc/*.cu`` for ``sm_90a`` into an
object, all sources at once in parallel processes, and links them into one
shared library with a plain C interface, which ``ctypes`` loads. The
library goes to ``osqp_tpu_torch/.build/`` (listed in ``.gitignore``) under
a name keyed by a hash of the sources, so an edited source is rebuilt and
an unchanged one is built once per checkout, at its first CUDA use.
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
_SOURCES = tuple(_PKG / "csrc" / f for f in
                 ("solve_kernel.cu", "shared_iter.cu", "fused_iter.cu",
                  "ruiz.cu", "check.cu"))
_HEADERS = tuple(_PKG / "csrc" / f for f in
                 ("fused_layout.h", "tiled_product.h", "shared_iter_layout.h"))
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
    for src in _SOURCES + _HEADERS:
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
    nvcc = _nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags.append("-Xptxas=-v")
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        failed = []
        for src, proc in zip(_SOURCES, procs):
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
        lib = os.path.join(tmp, out.name)
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               + "".join(log))
        os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    return out, "".join(log)


def _signatures():
    """{C entry: (restype, argtypes)} of every kernel entry."""
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ll = ctypes.c_longlong
    return {
        "osqp_admm_solve_shared": (i, [i, i, i] + [vp] * 27 + [i] * 5
                                   + [d, d, i, i] + [d] * 6 + [i, vp]),
        "osqp_admm_iterate_shared": (i, [i] + [vp] * 16 + [i] * 6
                                     + [d, d, vp]),
        "osqp_admm_iterate_shared_tiled": (i, [vp] * 15 + [i] * 6
                                           + [d, d, vp]),
        "osqp_admm_iterate_shared_mma": (i, [vp] * 17 + [i] * 5
                                         + [d, d, vp]),
        "osqp_admm_iterate_shared_smem_bytes": (ll, [i] * 4),
        "osqp_admm_iterate": (i, [i, i] + [vp] * 15 + [i] * 4 + [d, d, vp]),
        "osqp_admm_iterate_smem_bytes": (ll, [i] * 4),
        "osqp_ruiz_equilibrate": (i, [i, i] + [vp] * 17 + [i] * 4 + [vp]),
        "osqp_ruiz_smem_bytes": (ll, [i] * 4),
        "osqp_termination_check": (i, [i] * 3 + [vp] + [i] * 3 + [d] * 4
                                   + [i, i, vp]),
        "osqp_termination_check_smem_bytes": (ll, [i] * 4),
        "osqp_cuda_error_string": (ctypes.c_char_p, [i]),
    }


def declare(lib, names=None):
    """Declare the C entries ``names`` (all by default) of a loaded
    library, so that ctypes passes pointers and doubles whole."""
    for name, (res, args) in _signatures().items():
        if names is None or name in names:
            f = getattr(lib, name)
            f.restype, f.argtypes = res, args
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions."""
    path, _ = build()
    return declare(ctypes.CDLL(str(path)))


def check_launch(lib, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (0 is success)."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.osqp_cuda_error_string(err).decode()})")

"""The native engine's loader (``osqp_tpu/native.py``): ctypes bindings
over the JAX package's host C++ engine.

The runtime role the OSQP C library plays behind the reference wrapper
(SURVEY.md §1 layer 1): a single-threaded sparse direct ADMM engine for
latency-critical single QPs and host-side oracle solves. The C++ engine
implements Ruiz scaling, quasi-definite KKT LDLᵀ with inertia-based
non-convexity detection, the alpha-relaxed ADMM loop, adaptive rho with
numeric refactorization, infeasibility certificates, and active-set polish.

The port keeps its own copy of the sources (``csrc/native/solver.cpp``,
``ldl.cpp``, ``ldl.h``) and builds them at first use with the flags of the
JAX package's ``native/build.sh`` into ``osqp_tpu_torch/.build/``, under a
name keyed by a hash of the three files. A failed build raises.

``NativeModel`` mirrors :class:`osqp_tpu_torch.interface.Model`'s API
surface and returns the port's ``Results``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import constants as C
from .sparse import csc_from_matrix
from .types import Info, Results

_PKG = Path(__file__).resolve().parent
#: the port's copy of the engine's sources, and where it is built
SOURCE_DIR = _PKG / "csrc" / "native"
BUILD_DIR = _PKG / ".build"
_SOURCES = ("ldl.cpp", "solver.cpp")
_HEADERS = ("ldl.h",)
#: ``native/build.sh``'s compiler and flags
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def library_path() -> Path:
    """The engine's library, keyed by a hash of its sources and flags."""
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update((SOURCE_DIR / name).read_bytes())
    h.update(" ".join((CXX,) + FLAGS).encode())
    return BUILD_DIR / f"tpuqp-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless this source hash is already built; raises
    ``RuntimeError`` when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [CXX, *FLAGS, *(str(SOURCE_DIR / s) for s in _SOURCES),
               "-o", lib]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(f"{CXX} not found: the native engine is "
                               f"built from source at first use") from None
        if res.returncode != 0:
            raise RuntimeError(f"building the native engine failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    return out


_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def _load_lib():
    """Build the engine if needed, load it and declare its C entries."""
    lib = ctypes.CDLL(str(build()))
    lib.tpuqp_setup.restype = ctypes.c_void_p
    lib.tpuqp_setup.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, _f64p,            # P csc
        _i64p, _i64p, _f64p,            # A csc
        _f64p, _f64p, _f64p,            # q, l, u
        _f64p, _i64p]                   # settings, err
    lib.tpuqp_solve.restype = ctypes.c_int64
    lib.tpuqp_solve.argtypes = [ctypes.c_void_p, _f64p, _f64p, _f64p,
                                _f64p, _f64p]
    lib.tpuqp_update_q.argtypes = [ctypes.c_void_p, _f64p]
    lib.tpuqp_update_bounds.restype = ctypes.c_int64
    lib.tpuqp_update_bounds.argtypes = [ctypes.c_void_p, _f64p, _f64p]
    lib.tpuqp_update_P.restype = ctypes.c_int64
    lib.tpuqp_update_P.argtypes = [ctypes.c_void_p, _f64p,
                                   ctypes.c_void_p, ctypes.c_int64]
    lib.tpuqp_update_A.restype = ctypes.c_int64
    lib.tpuqp_update_A.argtypes = [ctypes.c_void_p, _f64p,
                                   ctypes.c_void_p, ctypes.c_int64]
    lib.tpuqp_warm_start.argtypes = [ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.tpuqp_update_rho.restype = ctypes.c_int64
    lib.tpuqp_update_rho.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tpuqp_update_setting.restype = ctypes.c_int64
    lib.tpuqp_update_setting.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_double]
    lib.tpuqp_get_iterates.restype = ctypes.c_int64
    lib.tpuqp_get_iterates.argtypes = [ctypes.c_void_p, _f64p, _f64p]
    lib.tpuqp_cleanup.argtypes = [ctypes.c_void_p]
    return lib


def _settings_array(s: dict) -> np.ndarray:
    # interval <= 0 passes through: the C++ engine then uses the reference's
    # timing-based mode (first adaptation after adaptive_rho_fraction of the
    # setup time; nondeterministic across runs, like the C core — tests that
    # need determinism set an explicit interval or adaptive_rho=False)
    interval = int(s.get("adaptive_rho_interval", 0))
    return np.array([
        float(s.get("rho", 0.1)),
        float(s.get("sigma", 1e-6)),
        float(s.get("alpha", 1.6)),
        float(s.get("eps_abs", 1e-3)),
        float(s.get("eps_rel", 1e-3)),
        float(s.get("eps_prim_inf", 1e-4)),
        float(s.get("eps_dual_inf", 1e-4)),
        float(s.get("max_iter", 4000)),
        float(s.get("check_termination", 25)),
        float(s.get("scaling", 10)),
        float(1 if s.get("adaptive_rho", True) else 0),
        float(interval),
        float(s.get("adaptive_rho_tolerance", 5.0)),
        float(1 if s.get("polish", False) else 0),
        float(s.get("polish_refine_iter", 3)),
        float(s.get("delta", 1e-6)),
        float(1 if s.get("scaled_termination", False) else 0),
        float(1 if s.get("verbose", True) else 0),
        float(s.get("adaptive_rho_fraction", 0.4)),
    ], dtype=np.float64)


class NativeModel:
    """Single-QP solver backed by the C++ engine (``Model``-compatible
    API). A host engine in both packages, so it takes no ``device``: the
    JAX package's engine is host C++ too, and nothing here falls back from
    the GPU."""

    def __init__(self):
        self._h = None
        self._lib = _load_lib()
        self._update_time = 0.0

    def setup(self, P=None, q=None, A=None, l=None, u=None, **settings):
        """Problem ingestion into the C++ workspace (CSC patterns kept for
        the value-only update contract; same kwargs as Model.setup)."""
        if P is None and q is None and A is None:
            raise ValueError("The problem does not have any variables!")
        n = P.shape[0] if P is not None else (
            len(q) if q is not None else A.shape[1])
        m = 0 if A is None else A.shape[0]
        if A is None:
            A = np.zeros((0, n))
            l = np.zeros(0)
            u = np.zeros(0)
        if P is None:
            P = np.zeros((n, n))
        if q is None:
            q = np.zeros(n)
        if l is None:
            l = -np.inf * np.ones(m)
        if u is None:
            u = np.inf * np.ones(m)
        self.n, self.m = int(n), int(m)
        self._P_pat = csc_from_matrix(P, triu=True)
        self._A_pat = csc_from_matrix(A, triu=False)
        self._l_np = np.asarray(l, float).copy()
        self._u_np = np.asarray(u, float).copy()
        if np.any(np.maximum(self._l_np, -C.OSQP_INFTY)
                  > np.minimum(self._u_np, C.OSQP_INFTY)):
            raise ValueError("l must be lower than or equal to u")
        self._warm = bool(settings.get("warm_start", True))
        self._settings = dict(settings)
        settings.pop("warm_start", None)
        settings.pop("time_limit", None)
        settings.pop("linsys_solver", None)
        settings.pop("dtype", None)
        sarr = _settings_array(settings)

        q = np.ascontiguousarray(q, dtype=np.float64)
        l = np.ascontiguousarray(l, dtype=np.float64)
        u = np.ascontiguousarray(u, dtype=np.float64)
        err = np.zeros(1, dtype=np.int64)
        self._h = self._lib.tpuqp_setup(
            self.n, self.m,
            np.ascontiguousarray(self._P_pat.indptr),
            np.ascontiguousarray(self._P_pat.rowind),
            np.ascontiguousarray(self._P_pat.vals),
            np.ascontiguousarray(self._A_pat.indptr),
            np.ascontiguousarray(self._A_pat.rowind),
            np.ascontiguousarray(self._A_pat.vals),
            q, l, u, sarr, err)
        if self._h is None or err[0] != 0:
            raise ValueError(
                "Error in setup: KKT factorization failed "
                "(non-convex problem or singular system)")
        return self

    def solve(self) -> Results:
        """Run the native ADMM solve; Results follow the reference
        NaN/certificate conventions."""
        self._check()
        import time as _time
        if not self._warm:
            # cold start (reference warm_start=False semantics): zero x, y, z
            self._lib.tpuqp_warm_start(self._h, None, None)
        t0 = _time.perf_counter()
        x = np.zeros(self.n)
        y = np.zeros(self.m)
        info_arr = np.zeros(11)
        pc = np.zeros(max(self.m, 1))
        dc = np.zeros(max(self.n, 1))
        self._lib.tpuqp_solve(self._h, x, y, info_arr, pc, dc)
        solve_time = _time.perf_counter() - t0
        status_val = int(info_arr[0])
        status = Info.status_from_val(status_val)
        info = Info(
            iter=int(info_arr[1]), status=status, status_val=status_val,
            status_polish=int(info_arr[7]), obj_val=float(info_arr[2]),
            pri_res=float(info_arr[3]), dua_res=float(info_arr[4]),
            setup_time=float(info_arr[8]),
            solve_time=float(info_arr[9]) or solve_time,
            update_time=self._update_time,
            polish_time=float(info_arr[10]),
            run_time=(self._update_time + (float(info_arr[9]) or solve_time)
                      + float(info_arr[10])),
            rho_updates=int(info_arr[5]), rho_estimate=float(info_arr[6]))
        self._update_time = 0.0
        nan_n = np.full(self.n, np.nan)
        nan_m = np.full(self.m, np.nan)
        if status in C.SOLUTION_PRESENT:
            return Results(x=x, y=y, info=info, prim_inf_cert=nan_m,
                           dual_inf_cert=nan_n)
        prim_cert = pc[:self.m] if status.startswith("Primal_inf") else nan_m
        dual_cert = dc[:self.n] if status.startswith("Dual_inf") else nan_n
        return Results(x=nan_n, y=nan_m, info=info,
                       prim_inf_cert=prim_cert, dual_inf_cert=dual_cert)

    def update(self, q=None, l=None, u=None, Px=None, Px_idx=None,
               Ax=None, Ax_idx=None):
        """In-place data update (interface.jl:235-440 semantics; one-sided
        bounds keep the other side from host caches)."""
        self._check()
        import time as _time
        _upd_t0 = _time.perf_counter()
        if q is not None:
            q = np.ascontiguousarray(q, dtype=np.float64)
            if q.shape[0] != self.n:
                raise ValueError(f"q must have length n = {self.n}")
            self._lib.tpuqp_update_q(self._h, q)
        if (l is not None) or (u is not None):
            # one-sided updates keep the other side from the host cache
            # (the reference's lcache/ucache pattern, interface.jl:252-313)
            l2 = np.ascontiguousarray(
                l if l is not None else self._l_np, np.float64)
            u2 = np.ascontiguousarray(
                u if u is not None else self._u_np, np.float64)
            if l2.shape[0] != self.m or u2.shape[0] != self.m:
                raise ValueError(f"bounds must have length m = {self.m}")
            rc = self._lib.tpuqp_update_bounds(self._h, l2, u2)
            if rc == 1:
                raise ValueError("l must be lower than or equal to u")
            if rc == 2:
                raise ValueError("refactorization failed after bounds update")
            self._l_np = l2.copy()
            self._u_np = u2.copy()
        for name, vals, idxs, fn, pat in (
                ("P", Px, Px_idx, self._lib.tpuqp_update_P, self._P_pat),
                ("A", Ax, Ax_idx, self._lib.tpuqp_update_A, self._A_pat)):
            if vals is None:
                continue
            vals = np.ascontiguousarray(vals, dtype=np.float64)
            if idxs is None:
                if vals.shape[0] != pat.nnz:
                    raise ValueError(
                        f"{name}x must have length nnz = {pat.nnz}")
                rc = fn(self._h, vals, None, vals.shape[0])
            else:
                idxs = np.ascontiguousarray(idxs, dtype=np.int64)
                rc = fn(self._h, vals,
                        idxs.ctypes.data_as(ctypes.c_void_p), vals.shape[0])
            if rc != 0:
                raise ValueError(f"Error updating {name} (code {rc})")
        # accumulated into the next solve's Info.update_time/run_time
        # (reference CInfo update_time, types.jl:94)
        self._update_time += _time.perf_counter() - _upd_t0

    _SETTING_KEYS = {"max_iter": 0, "eps_abs": 1, "eps_rel": 2,
                     "verbose": 10,
                     "eps_prim_inf": 3, "eps_dual_inf": 4, "alpha": 5,
                     "delta": 6, "polish": 7, "polish_refine_iter": 8,
                     "check_termination": 9}

    def update_settings(self, **kwargs):
        """Post-setup settings update (interface.jl:442-670): one native call
        per changed setting; rho additionally refactorizes."""
        self._check()
        for k in kwargs:
            if k not in C.UPDATABLE_SETTINGS:
                raise ValueError(f"{k} cannot be updated or is not recognized")
        for k, v in kwargs.items():
            if k == "rho":
                rc = self._lib.tpuqp_update_rho(self._h, float(v))
                if rc != 0:
                    raise ValueError("refactorization failed after rho update")
            elif k in self._SETTING_KEYS:
                self._lib.tpuqp_update_setting(
                    self._h, self._SETTING_KEYS[k], float(v))
            # verbose / warm_start / time_limit are host-level no-ops here
        self._settings.update(kwargs)

    def warm_start(self, x=None, y=None):
        """osqp_warm_start semantics: providing only x zeroes y and vice
        versa; z is set to A x."""
        self._check()
        xa = np.ascontiguousarray(x, np.float64) if x is not None else None
        ya = np.ascontiguousarray(y, np.float64) if y is not None else None
        self._lib.tpuqp_warm_start(
            self._h,
            xa.ctypes.data_as(ctypes.c_void_p) if xa is not None else None,
            ya.ctypes.data_as(ctypes.c_void_p) if ya is not None else None)

    def get_state(self) -> dict:
        """Snapshot the ADMM iterates (checkpoint/resume parity with
        Model.get_state)."""
        self._check()
        x = np.zeros(self.n)
        y = np.zeros(self.m)
        self._lib.tpuqp_get_iterates(self._h, x, y)
        return {"x": x, "y": y}

    def set_state(self, state: dict) -> None:
        """Restore iterates captured by :meth:`get_state`."""
        self._check()
        self.warm_start(x=state["x"], y=state["y"])

    def dimensions(self):
        """(n, m)."""
        self._check()
        return self.n, self.m

    def _check(self):
        if self._h is None:
            raise RuntimeError("Model is empty: call setup() first")

    def clean(self):
        """Explicitly free the C++ workspace (reference ``OSQP.clean!``,
        interface.jl:223-233; also runs from the GC finalizer). The model
        is empty afterwards until the next ``setup()``."""
        self.__del__()
        return self

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            try:
                self._lib.tpuqp_cleanup(self._h)
            except Exception:
                pass
            self._h = None

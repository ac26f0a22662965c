"""Serving artifacts (``osqp_tpu/serve.py``): a prepared solver, or a
shape-specialized cold solver, written to one file that a serving process
loads and answers requests from.

The JAX package's artifact is a ``jax.export`` StableHLO program with the
problem structure baked in, and serving it needs only jax. The port's
prepared solve is a host loop that reads the device between rho legs
(``shared_core.solve_batch_shared``), which ``torch.export`` cannot
capture. So the port's artifact is data and the port's code drives it:

* :func:`export_prepared` writes a prepared ``BatchedSolver``'s workspace
  (the unscaled P and A for polish, the scaled Pb and Ab, the six fields of
  ``SharedScaling`` and the four of ``FactorCache`` as they stand at
  export), the settings, B, n, m and the dtype into an ``.npz`` read with
  ``allow_pickle=False``;
* :func:`export_solver` writes the settings and shapes of a cold solver
  whose P and A arrive with every request (OSQP codegen's mode 2);
* :func:`load` returns a :class:`PreparedServer` or a
  :class:`SolverServer` on the device it is given.

What differs from the JAX package: serving needs ``osqp_tpu_torch`` (not
only ``torch``), since the artifact holds no program. A ``torch.export``
artifact, with the kernels registered through ``torch.library``, waits
for a rho decision made on the device.

Device rule: the artifact holds no compiled code, so it runs on the device
that :func:`load` names, "cuda" unless given (raising without a GPU). The
leg kernel's wrapper picks its group at launch, and a CUDA tensor reaches
the kernel or the call raises; ``device="cpu"`` runs the kernels' plain
twins. A request is never moved from the GPU to the CPU: a CUDA tensor
given to a server on the CPU raises.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .batch import BatchedSolver, prepared_request
from .core import resolve_device, torch_dtype
from .settings import Settings
from .shared_core import FactorCache, SharedScaling
from .types import Info, Results

#: Artifact container format: an npz of the workspace's arrays and metadata.
_MAGIC = "osqp_tpu_torch-artifact-v1"
#: The JAX package's artifact, which holds a StableHLO program.
_REFERENCE_MAGIC = "osqp_tpu-aot-v1"
#: The output fields of :meth:`PreparedServer.call_flat`, by their names in
#: ``SolveOutput``.
_OUT_FIELDS = ("x", "y", "z", "status", "iter", "obj_val", "pri_res",
               "dua_res", "status_polish", "prim_cert", "dual_cert",
               "rho_updates", "rho_estimate")
_PREP_ARRAYS = ("P", "A", "Pb", "Ab")


def _check_time_limit(settings):
    if settings.time_limit and settings.time_limit > 0:
        raise ValueError(
            "time_limit uses a host-side chunked driver and is not part of "
            "a serving artifact; export with time_limit=0 and enforce "
            "deadlines in the serving layer")


def _settings_json(settings) -> str:
    d = settings.asdict()
    d["dtype"] = np.dtype(settings.resolve_dtype()).name
    return json.dumps(d)


def _meta(kind, settings, B, n, m, device_type):
    return dict(
        magic=np.array(_MAGIC), kind=np.array(kind),
        B=np.int64(B), n=np.int64(n), m=np.int64(m),
        dtype=np.array(np.dtype(settings.resolve_dtype()).name),
        settings=np.array(_settings_json(settings)),
        torch_version=np.array(torch.__version__),
        device_type=np.array(device_type))


def _write(arrays, path):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_prepared(solver, B: int, path: Optional[str] = None) -> bytes:
    """Write a prepared :class:`osqp_tpu_torch.batch.BatchedSolver`
    (``kkt_mode="shared"``, after ``prepare``) as an artifact for batch
    size ``B``: its problem structure, equilibration, settings and the
    factor it carries now. Returns the artifact's bytes, also written to
    ``path`` if given. :func:`load` serves it."""
    if not hasattr(solver, "_prep"):
        raise ValueError("export_prepared requires a prepare()-d solver")
    s = solver.settings
    _check_time_limit(s)
    p = solver._prep
    n, m = int(p["P"].shape[0]), int(p["A"].shape[0])

    def host(t):
        return t.detach().cpu().numpy()

    arrays = _meta("prepared", s, int(B), n, m, p["P"].device.type)
    arrays.update({k: host(p[k]) for k in _PREP_ARRAYS})
    arrays.update({f: host(getattr(p["scal"], f))
                   for f in SharedScaling._fields})
    arrays.update({f: host(getattr(p["factor"], f))
                   for f in FactorCache._fields})
    return _write(arrays, path)


def export_solver(settings, B: int, n: int, m: int,
                  path: Optional[str] = None) -> bytes:
    """Write a shape-specialized cold solver: the analogue of OSQP
    codegen's matrix-update mode (embedded mode 2). Every request carries
    its own ``P (n,n)``, ``A (m,n)``, ``q (B,n)``, ``l``/``u (B,m)``;
    scaling and factorization run on each. Use :func:`export_prepared`
    when the structure is fixed."""
    _check_time_limit(settings)
    return _write(_meta("solver", settings, int(B), int(n), int(m), "none"),
                  path)


def _results(outs) -> Results:
    """numpy ``Results`` from the flat output tuple (``_OUT_FIELDS``
    order), per-lane Info fields as arrays; z stays on the device."""
    (x, y, status, it, obj, pri, dua, st_pol, pcert, dcert, rho_upd,
     rho_est) = (t.cpu().numpy() for k, t in enumerate(outs) if k != 2)
    info = Info(
        iter=it, status=np.array(
            [C.STATUS_MAP.get(int(v), "Unsolved") for v in status]),
        status_val=status, status_polish=st_pol, obj_val=obj, pri_res=pri,
        dua_res=dua, rho_updates=rho_upd, rho_estimate=rho_est)
    return Results(x=x, y=y, info=info, prim_inf_cert=pcert,
                   dual_inf_cert=dcert)


class _Server:
    """Shapes, dtype, device and input conversion of a loaded artifact."""

    #: status-code -> string (reference src/constants.jl:9-21)
    STATUS = dict(C.STATUS_MAP)

    def __init__(self, meta, settings, device):
        self.B, self.n, self.m = (int(meta[k]) for k in ("B", "n", "m"))
        self.dtype = np.dtype(str(meta["dtype"]))
        self.settings = settings
        self.device = device

    def _t(self, v, shape, name):
        """A request's input as a tensor on the server's device. A CUDA
        tensor given to a server on the CPU raises: a request never
        leaves the GPU for the CPU."""
        tdt = torch_dtype(self.dtype)
        if torch.is_tensor(v):
            if v.device.type == "cuda" and self.device.type != "cuda":
                raise ValueError(
                    f"{name} is on {v.device} but the server runs on "
                    f"{self.device}; load the artifact with device='cuda'")
            t = v.to(dtype=tdt, device=self.device)
        else:
            t = torch.as_tensor(np.asarray(v), dtype=tdt, device=self.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the "
                             f"artifact takes {shape}")
        return t

    def _requests(self, q, l, u, x0, y0):
        B, n, m = self.B, self.n, self.m
        tdt = torch_dtype(self.dtype)
        if x0 is None:
            x0 = torch.zeros((B, n), dtype=tdt, device=self.device)
        if y0 is None:
            y0 = torch.zeros((B, m), dtype=tdt, device=self.device)
        return (self._t(q, (B, n), "q"), self._t(l, (B, m), "l"),
                self._t(u, (B, m), "u"), self._t(x0, (B, n), "x0"),
                self._t(y0, (B, m), "y0"))


class SolverServer(_Server):
    """Serves a shape-specialized cold-solver artifact (see
    :func:`export_solver`): every request carries its own P and A, and
    runs what ``BatchedSolver(kkt_mode="shared").solve`` runs, polish
    included when the settings ask for it."""

    def __init__(self, meta, settings, device):
        super().__init__(meta, settings, device)
        self._solver = BatchedSolver(settings, kkt_mode="shared",
                                     device=device)

    def solve(self, P, A, q, l, u, x0=None, y0=None) -> Results:
        n, m = self.n, self.m
        P = self._t(P, (n, n), "P")
        A = self._t(A, (m, n), "A")
        q, l, u, x0, y0 = self._requests(q, l, u, x0, y0)
        out = self._solver.solve(P, q, A, l, u, x0=x0, y0=y0)
        return _results(_flat(out))


def _flat(out):
    """The flat output tuple of a solve, every field a tensor (a solve
    without polish leaves ``status_polish`` the int 0)."""
    flat = [getattr(out, f) for f in _OUT_FIELDS]
    k = _OUT_FIELDS.index("status_polish")
    if not torch.is_tensor(flat[k]):
        flat[k] = torch.full_like(out.status, int(flat[k]))
    return tuple(flat)


class PreparedServer(_Server):
    """Serves a prepared artifact (see :func:`export_prepared`), carrying
    the adapted factor across requests (the persistent-workspace economics
    of the reference's update!/solve! loop, src/interface.jl:408-440).
    Each request runs :func:`osqp_tpu_torch.batch.prepared_request`, what
    ``BatchedSolver.solve_prepared`` runs, so on one device a served
    request equals the live one bit for bit.

    Concurrency: the carried factor is plain instance state, updated per
    call; use one ``PreparedServer`` per serving thread (or a lock).
    ``load`` on the same bytes is cheap.
    """

    #: index map for the flat output tuple of :meth:`solve_device`
    FIELDS = ("x", "y", "z", "status", "iter", "obj_val", "pri_res",
              "dua_res", "status_polish", "prim_inf_cert", "dual_inf_cert",
              "rho_updates", "rho_estimate")

    def __init__(self, meta, tensors, settings, device):
        super().__init__(meta, settings, device)
        self._prep = {k: tensors[k] for k in _PREP_ARRAYS}
        self._prep["scal"] = SharedScaling(
            *(tensors[f] for f in SharedScaling._fields))
        self._factor = FactorCache(*(tensors[f] for f in FactorCache._fields))

    def call_flat(self, q, l, u, x0, y0):
        """One request on tensors of the server's dtype and device: returns
        the flat output tuple (:data:`FIELDS` order) and updates the carried
        factor."""
        out, self._factor = prepared_request(self._prep, self.settings, q, l,
                                             u, x0, y0, self._factor)
        return _flat(out)

    def solve_device(self, q, l, u, x0=None, y0=None):
        """Hot-loop variant of :meth:`solve`: takes tensors (or host
        arrays) and returns the flat tuple of tensors on the server's
        device in :data:`FIELDS` order, with no host copy, so a serving
        loop that feeds ``x``/``y`` back as the next warm start copies to
        the host only the fields it reads."""
        return self.call_flat(*self._requests(q, l, u, x0, y0))

    def solve(self, q, l, u, x0=None, y0=None) -> Results:
        """Batched re-solve with the artifact's problem structure. Returns
        the live solver's record as numpy: x/y (B-stacked, NaN-filled when
        no solution), per-lane Info fields as arrays."""
        return _results(self.solve_device(q, l, u, x0, y0))


def load(path_or_bytes, device=None):
    """Read an artifact written by :func:`export_prepared` (returns a
    :class:`PreparedServer`) or :func:`export_solver` (returns a
    :class:`SolverServer`), serving on ``device``: "cuda" unless given,
    raising when no GPU is present."""
    src = (io.BytesIO(bytes(path_or_bytes))
           if isinstance(path_or_bytes, (bytes, bytearray)) else path_or_bytes)
    try:
        z = np.load(src, allow_pickle=False)
    except (ValueError, zipfile.BadZipFile) as e:
        raise ValueError(f"not an osqp_tpu_torch artifact ({e})") from None
    if not isinstance(z, np.lib.npyio.NpzFile):
        raise ValueError("not an osqp_tpu_torch artifact (not an npz "
                         "container)")
    with z:
        arrays = {k: z[k] for k in z.files}
    magic = str(arrays.get("magic", ""))
    if magic == _REFERENCE_MAGIC:
        raise ValueError(
            "this is an osqp_tpu (JAX) artifact: it holds a StableHLO "
            "program, which the port cannot run; export the solver with "
            "osqp_tpu_torch.serve.export_prepared or export_solver instead")
    kind = str(arrays.get("kind", ""))
    if magic != _MAGIC or kind not in ("prepared", "solver"):
        raise ValueError("not an osqp_tpu_torch artifact")
    dev = resolve_device(device)
    settings = Settings(**json.loads(str(arrays["settings"])))
    if kind == "solver":
        return SolverServer(arrays, settings, dev)
    tdt = torch_dtype(str(arrays["dtype"]))
    names = _PREP_ARRAYS + SharedScaling._fields + FactorCache._fields
    tensors = {k: torch.as_tensor(arrays[k], dtype=tdt, device=dev)
               for k in names}
    return PreparedServer(arrays, tensors, settings, dev)

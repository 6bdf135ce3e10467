"""Fixed-shape solver artifacts, the analogue of the reference's EMBEDDED
mode (counterpart of ``osqp_tpu/export.py``; CMakeLists.txt:48-55,
include/osqp.h:35-60).

    blob = export_solver(B=64, n=10, m=20, dtype="float32", polish=True)
    open("solver.bin", "wb").write(blob)
    ...
    fn = load_solver(open("solver.bin", "rb").read())   # on the card
    res = fn(P, q, A, l, u)   # dict of per-instance outputs

The blob fixes (B, n, m), the dtype, the platforms it may run on
(``"cuda"``, ``"cpu"``) and the full settings; the callable refuses
inputs of another shape or dtype with a ValueError and runs the whole
pipeline (Ruiz scaling, rho classification, factorization, the masked
ADMM loop over the whole iteration range, optional polish, unscaling and
certificates) in one unsegmented solve.

Format 2, which :func:`export_solver` writes for every backend and
:func:`export_sparse_solver` for the sparse path, holds the solve as one
program, as the JAX package's ``jax.export`` blob does: for each platform
the ``torch.export.save`` bytes of
:class:`~osqp_tpu_torch.program.SolveProgram` (or, sparse,
:class:`~osqp_tpu_torch.program.SparseSolveProgram`) traced at the fixed
shapes (``torch.export.export(..., strict=False)``; its loops and
branches are ``while_loop`` and ``cond`` operators), and for ``"cuda"``
the bytes of the library of the kernels' ``torch.library`` operators
with the torch version that built it.  A ``"cuda"`` program is traced on
the card: a machine without one refuses it.  Such a blob runs with torch
and the blob alone, no ``osqp_tpu_torch`` (README, "Export"):

    spec = torch.load(io.BytesIO(blob), weights_only=True)
    # "cuda": write spec["ops_library"] to a file, torch.ops.load_library it
    solve = torch.export.load(io.BytesIO(spec["programs"]["cuda"])).module()
    out = dict(zip(spec["fields"], solve(P, q, A, l, u)))

and :func:`load_solver` / :func:`load_sparse_solver` do just that.  Run
eagerly, the loaded program reads each turn's predicate of its loops and
each branch's on the host.  The program holds no host check of the live
entry points: ``block_tridiag``'s band check
(``linsys.block_tridiag.validate_structure``) runs in ``solve_batch`` and
the ``Solver``, not in the program, as the JAX package's
``solve_batch_jit`` leaves it to ``solve_batch``.

Format 1, which earlier versions wrote for the dense backends other than
``dense_inv`` and for the sparse path, is a ``torch.save`` of the
settings alone (and, sparse, the pattern and maps): no exporter writes it
now, and both loaders still read it, its callable running the live
unsegmented solve (so it needs ``osqp_tpu_torch`` installed, and on the
card builds the kernels at first use).  Both formats are plain data
(``torch.load(..., weights_only=True)`` reads them).  A sparse blob also
carries its sparsity pattern and its CSC-nnz -> ELL-slot value maps
(``spec["operands"]``), which a format-2 program holds as buffers, and
its callable takes value vectors only.  The sparse polish's CG cap
(``OSQP_TPU_POLISH_CG_CAP``, read at export) is fixed in a format-2
sparse blob.  :data:`last_seconds` splits the last export's time into
tracing, saving and the operators' library.
"""

from __future__ import annotations

import dataclasses
import io
import os
import tempfile
import time

import numpy as np
import torch

from . import __version__
from . import _build
from . import admm as admm_mod
from . import constants as con
from .batch import _postprocess, _prepare, solve_batch
from .program import FIELDS, SolveProgram, SparseSolveProgram, make_dyn, sparse_operands
from .solver import Settings, make_config, reject_time_based_rho, resolve_device, torch_dtype, validate_settings
from .sparse_ops import ell_with_values

FORMAT = "osqp_tpu_torch.export"
FORMAT_VERSION = 2  # the traced program; 1: the settings alone
FORMATS = (1, 2)  # what load_solver reads
PLATFORMS = ("cuda", "cpu")

# Stable output order of the calling convention (the JAX package's).
_FIELDS = FIELDS


def _settings(dtype, settings: dict, **defaults) -> Settings:
    """Validated settings with the dtypes as names (plain data)."""
    s = Settings(dtype=dtype, **{**defaults, **settings})
    validate_settings(s)
    name = lambda d: str(torch_dtype(d)).removeprefix("torch.")
    s.dtype = name(s.dtype)
    if s.polish_dtype is not None:
        s.polish_dtype = name(s.polish_dtype)
    return s


def _platforms(platforms) -> list[str]:
    """``platforms`` as a list of names; None means the card."""
    names = ["cuda"] if platforms is None else [str(p).lower() for p in platforms]
    bad = [p for p in names if p not in PLATFORMS]
    if not names or bad:
        raise ValueError(f"platforms must name some of {PLATFORMS}, not {platforms!r}")
    return names


def _dump(spec: dict, version: int) -> bytes:
    buf = io.BytesIO()
    torch.save({"format": FORMAT, "format_version": version, "version": __version__, **spec}, buf)
    return buf.getvalue()


def _load(blob: bytes, kind: str) -> dict:
    spec = torch.load(io.BytesIO(blob), weights_only=True)
    if not isinstance(spec, dict) or spec.get("format") != FORMAT:
        raise ValueError("not an osqp_tpu_torch solver artifact")
    if spec["format_version"] not in FORMATS:
        raise ValueError(f"artifact format {spec['format_version']}, this package reads {FORMATS}")
    if spec["kind"] != kind:
        loader = {"dense": "load_solver", "sparse": "load_sparse_solver"}[spec["kind"]]
        raise ValueError(f"a {spec['kind']} artifact: load it with {loader}")
    return spec


def _device(spec: dict, device) -> torch.device:
    """The device to run on (the card unless asked), refused where the
    blob does not list its platform."""
    dev = resolve_device(device)
    if dev.type not in spec["platforms"]:
        raise ValueError(f"this artifact was exported for {spec['platforms']}, not {dev.type}")
    return dev


def _check(args, names, shapes, dtype: torch.dtype):
    """Each input's shape and dtype as the artifact fixes them (a tensor's
    dtype, or an array's), else a ValueError."""
    for v, name, shape in zip(args, names, shapes):
        vdt = v.dtype if isinstance(v, torch.Tensor) else getattr(torch, np.asarray(v).dtype.name, None)
        if tuple(v.shape) != tuple(shape) or vdt != dtype:
            raise ValueError(
                f"{name}: expected shape {tuple(shape)} of {dtype}, got {tuple(v.shape)} of {vdt}"
            )


def _outputs(res) -> dict:
    return {f: getattr(res, f) for f in _FIELDS}


def _program_settings(s: Settings) -> dict:
    return {k: v for k, v in dataclasses.asdict(s).items() if k not in ("verbose", "time_limit")}


# Seconds of the last format-2 export by part, the host's clock: "trace"
# (torch.export.export), "save" (torch.export.save) over its platforms, and
# "library" (the operators' library built or found, and read).
last_seconds: dict = {}


def _trace(module: torch.nn.Module, shapes, dtype: torch.dtype, platform: str, seconds: dict) -> bytes:
    """The ``torch.export.save`` bytes of ``module`` traced on ``platform``
    over inputs of these shapes, the seconds of each part added to
    ``seconds``.  The kernels' wrappers take their operators on the card
    and their plain versions on the CPU."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' program is traced on a CUDA card, and this machine has none")
    dev = torch.device(platform)
    args = tuple(torch.zeros(shape, dtype=dtype, device=dev) for shape in shapes)
    t0 = time.perf_counter()
    program = torch.export.export(module.to(dev), args, strict=False)
    program.example_inputs = None  # else the archive keeps the traced inputs (a GB at the headline)
    t1 = time.perf_counter()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    seconds["trace"] += t1 - t0
    seconds["save"] += time.perf_counter() - t1
    return buf.getvalue()


def _programs(spec: dict, make, shapes, dtype: torch.dtype) -> dict:
    """``spec`` with format 2's entries: the program ``make()`` traced for
    each platform, and for ``"cuda"`` the operators' library."""
    seconds = dict(trace=0.0, save=0.0, library=0.0)
    spec.update(fields=list(FIELDS), torch_version=str(torch.__version__),
                programs={p: _trace(make(), shapes, dtype, p, seconds) for p in spec["platforms"]})
    if "cuda" in spec["platforms"]:
        t0 = time.perf_counter()
        path = _build.build_ops()
        spec.update(ops_library=path.read_bytes(), ops_library_name=path.name)
        seconds["library"] = time.perf_counter() - t0
    last_seconds.clear()
    last_seconds.update(seconds)
    return spec


def export_solver(B: int, n: int, m: int, dtype="float32", platforms=None, **settings) -> bytes:
    """Serialize a batched solver for fixed (B, n, m) and settings.

    ``platforms``: a list of ``"cuda"`` and/or ``"cpu"``, the devices the
    loaded callable may run on; the card by default.  Every backend
    (``dense_inv``, ``kkt_lu``, ``dense_chol``, ``cg``, ``block_tridiag``
    with its ``block_size``) writes format 2, the traced program for each
    platform (a ``"cuda"`` one only on a machine with a card).  The
    program runs no host check of the data: ``block_tridiag``'s band check
    (``validate_structure``) is the live entry points' and the caller's,
    as in the JAX package, whose artifact leaves it to ``solve_batch``.
    """
    s = _settings(dtype, settings)
    reject_time_based_rho(s)
    spec = dict(kind="dense", B=int(B), n=int(n), m=int(m), dtype=s.dtype, platforms=_platforms(platforms),
                settings=dataclasses.asdict(s))
    B, n, m = spec["B"], spec["n"], spec["m"]
    shapes = ((B, n, n), (B, n), (B, m, n), (B, m), (B, m))
    make = lambda: SolveProgram(n, m, **_program_settings(s))
    return _dump(_programs(spec, make, shapes, torch_dtype(s.dtype)), 2)


def _load_ops(spec: dict) -> None:
    """The blob's operator library, loaded into this process unless it
    (by its name, which carries its digest) is loaded already."""
    name = spec["ops_library_name"]
    if _build.ops_loaded in (None, name) and not hasattr(torch.ops.osqp_tpu_torch, "admm_iter"):
        fd, path = tempfile.mkstemp(suffix=".so", prefix="osqp_torch_ops_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(spec["ops_library"])
            torch.ops.load_library(path)
        finally:
            os.unlink(path)
        _build.ops_loaded = name
    elif _build.ops_loaded != name:
        raise ValueError(f"this artifact's operators are {name}; this process has loaded "
                         f"{_build.ops_loaded or 'another library of the namespace osqp_tpu_torch'}")


def _loaded_program(spec: dict, dev: torch.device, names, shapes, dtype: torch.dtype):
    """The callable of a format-2 blob on ``dev``: its program loaded (and
    on the card its operator library), a torch other than the one that
    made it refused."""
    if spec["torch_version"] != str(torch.__version__):
        raise ValueError(f"this artifact was made with torch {spec['torch_version']}, this is {torch.__version__}")
    if dev.type == "cuda":
        _load_ops(spec)
    # Full-precision float32 products, as linalg.py pins them: the set-up
    # GEMMs must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    solve = torch.export.load(io.BytesIO(spec["programs"][dev.type])).module()

    def fn(*args):
        _check(args, names, shapes, dtype)
        args = (torch.as_tensor(v, device=dev).contiguous() for v in args)
        with torch.no_grad():
            return dict(zip(spec["fields"], solve(*args)))

    return fn


def load_solver(blob: bytes, device=None):
    """Deserialize an exported solver into a callable

        fn(P, q, A, l, u) -> dict(field -> tensor)

    on ``device`` (the card unless asked; the blob must list its
    platform), over inputs of the exported shapes and dtype.  A format-2
    blob loads its program (and on the card its operator library) and
    refuses a torch other than the one that made it."""
    spec = _load(blob, "dense")
    dev = _device(spec, device)
    B, n, m = spec["B"], spec["n"], spec["m"]
    settings = dict(spec["settings"])
    dtype = torch_dtype(settings["dtype"])
    shapes = ((B, n, n), (B, n), (B, m, n), (B, m), (B, m))
    names = ("P", "q", "A", "l", "u")
    if spec["format_version"] == 2:
        return _loaded_program(spec, dev, names, shapes, dtype)

    def fn(P, q, A, l, u):
        _check((P, q, A, l, u), names, shapes, dtype)
        return _outputs(solve_batch(P, q, A, l, u, segmented=False, device=dev, **settings))

    return fn


def export_sparse_solver(P, A, B: int = 1, dtype="float32", platforms=None, **settings) -> bytes:
    """Serialize a sparse solver for a fixed sparsity pattern.

    The ELL pattern and the CSC-nnz -> ELL-slot value maps (the
    PtoKKT/AtoKKT analogue, kkt.c:184-212) of P's upper triangle and of A
    go into the blob, as the buffers of its traced program
    (:class:`~osqp_tpu_torch.program.SparseSolveProgram`, format 2) and
    as plain data (``spec["operands"]``); the loaded callable takes only
    values,

        fn(P_val (nnzP,), q (B, n), A_val (nnzA,), l (B, m), u (B, m))

    in the CSC order of ``triu(P)`` and ``A`` as given here, the value
    vectors osqp_update_P/A take (osqp.c:1031-1062).  The backend is the
    matrix-free cg, the sparse path's only one.  ``platforms`` as
    :func:`export_solver` takes them.
    """
    s = _settings(dtype, settings, linsys_solver="cg")
    if s.linsys_solver != "cg":
        raise con.OSQPError(
            con.ErrorCode.SETTINGS_VALIDATION_ERROR,
            "the sparse path supports only the matrix-free 'cg' backend",
        )
    reject_time_based_rho(s)
    operands = sparse_operands(P, A)
    (n, _), (m, _) = operands["P"]["shape"], operands["A"]["shape"]
    spec = dict(kind="sparse", B=int(B), n=n, m=m, dtype=s.dtype, platforms=_platforms(platforms),
                settings=dataclasses.asdict(s), operands=operands)
    shapes = ((operands["P"]["nnz"],), (B, n), (operands["A"]["nnz"],), (B, m), (B, m))
    make = lambda: SparseSolveProgram(operands, spec["B"], **_program_settings(s))
    return _dump(_programs(spec, make, shapes, torch_dtype(s.dtype)), 2)


def load_sparse_solver(blob: bytes, device=None):
    """Deserialize a sparse-pattern artifact into a callable

        fn(P_val, q, A_val, l, u) -> dict(field -> tensor)

    (the calling convention it was exported with; the pattern and the
    value maps travel inside the blob) on ``device``, the card unless
    asked.  A format-2 blob loads its program as :func:`load_solver`
    does; a format-1 blob (of an earlier version) runs the live
    unsegmented solve on its pattern and maps."""
    spec = _load(blob, "sparse")
    dev = _device(spec, device)
    B, n, m = spec["B"], spec["n"], spec["m"]
    s = Settings(**spec["settings"])
    dtype = torch_dtype(s.dtype)
    nnz = spec["operands"]["P"]["nnz"], spec["operands"]["A"]["nnz"]
    names = ("P_val", "q", "A_val", "l", "u")
    shapes = ((nnz[0],), (B, n), (nnz[1],), (B, m), (B, m))
    if spec["format_version"] == 2:
        return _loaded_program(spec, dev, names, shapes, dtype)
    cfg = make_config(n, m, s, dtype)
    dyn = make_dyn(s, dtype)
    ops = {name: (*(t.to(dev) for t in op["pattern"]), tuple(op["shape"]), *(t.to(dev) for t in op["maps"]))
           for name, op in spec["operands"].items()}
    on = lambda v: torch.as_tensor(v, device=dev).contiguous()

    def fn(P_val, q, A_val, l, u):
        _check((P_val, q, A_val, l, u), names, shapes, dtype)
        P_ell = ell_with_values(*ops["P"], _host(P_val), dtype, batch=B, device=dev)
        A_ell = ell_with_values(*ops["A"], _host(A_val), dtype, batch=B, device=dev)
        clamp = lambda v: torch.clamp(on(v), -con.OSQP_INFTY, con.OSQP_INFTY)
        rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
        scaled, scl, rho_state, factor, it = _prepare(cfg, int(s.scaling), P_ell, on(q), A_ell, clamp(l), clamp(u),
                                                      rho0, dyn, None, None)
        fin = admm_mod.solve_core(cfg, scaled, scl, dyn, rho_state, factor, it)
        return _outputs(_postprocess(cfg, bool(s.polish), int(s.polish_refine_iter), scaled, scl, dyn, fin))

    return fn


def _host(values):
    """A value vector as numpy float64, where ell_with_values takes it."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
    return np.asarray(values, np.float64)

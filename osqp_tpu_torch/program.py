"""The batched solve as one traceable program (counterpart of
``osqp_tpu/batch.py:153-176``, ``solve_batch_jit``, and of the while loop
of ``osqp_tpu/admm.py:296-385``).

:func:`solve_batch_program` runs the whole pipeline of any backend on
dense operands, and of the ``cg`` backend on ELL operands, with no host
read and no Python branch on a device value, so that ``torch.export``
traces it into one program: Ruiz scaling (K4, or on ELL operands K5's
matrix-free sweeps), rho classification, the factor, the ADMM loop with
K3's products at the checks, finalize, the optional polish (K8 and K3;
on ELL operands the one-pass polish whose Schur system K6's loop
solves), unscaling and certificates.  The factor and each iteration's
KKT solve are the backend's:

* ``dense_inv``: the inverse through K2 with its residual guard, the
  loop body K1 or K1r;
* ``kkt_lu``: K8's factor from the KKT blocks and its solve;
* ``dense_chol``: torch's batched Cholesky (``cholesky_ex``) and
  ``cholesky_solve``, as the JAX package leaves them to its library;
* ``block_tridiag``: K7's factor and solve (two GEMVs with A beside);
* ``cg`` on dense operands: K6's step, the stepwise PCG with batched
  GEMV products; on ELL operands K5's fused start and K6's device loop.

Its decisions are device control flow:

* the refined or the plain loop body is a :func:`flow.cond` on
  ``dense_inv.refine_signal``, outside the loop (JAX: admm.py:375-385);
  a backend without fused bodies (every one but ``dense_inv``) has no
  refine ``cond``: its turn runs ``admm.step``'s generic body;
* the loop is a :func:`flow.while_loop` while some instance is active
  and ``k <= max_iter``; one turn runs one check interval, its
  iterations masked by ``k <= max_iter``, so the check sits at the turn's
  end and a run that stops at a check stops where the live loop does;
* the rho adaptation is a :func:`flow.cond` on ``k % interval == 0`` at
  each place of the turn where that can hold, and its refactor (any
  backend's ``init``) one on ``upd.any()``, the new factor merged per
  instance (``admm._select_factor``: ``kkt_lu``'s perm goes with its lu);
* the residual guard is a :func:`flow.cond` on ``bad.any()`` over the
  whole batch (``dense_inv.guarded_inverse``);
* each CG solve of ``cg`` on dense operands on the card is a
  :func:`flow.while_loop` of 8 steps a turn with the stop test before it
  and a :func:`flow.cond` for the steps left below the cap
  (``ops/cg.py:pcg_solve_stepwise_program``); on ELL operands one call of
  K6's loop; on CPU tensors the plain loop, a :func:`flow.while_loop`.

The pieces between those decisions are the live solve's own
(``batch._prepare``, ``admm.step``, ``admm._apply_check``,
``admm._apply_rho_adaptation``, ``admm.finalize``, ``batch._postprocess``).
Run eagerly, the program reads each decision on the host through
``linalg.host_read`` and gives ``solve_batch``'s bits (``segmented=False``
or a single segment: the same iterations over the same range), except
where the residual guard fires (a batched Cholesky).  Under tracing the
kernels' wrappers call their ``torch.library`` ops on CUDA tensors and
their plain versions on CPU tensors.  :class:`SolveProgram` is the module
that ``export.export_solver`` traces: settings are constants of the
program, its inputs P, q, A, l, u; it runs no host check of the data
(``block_tridiag.validate_structure`` stays with the live entry points).
:class:`SparseSolveProgram` is ``export.export_sparse_solver``'s: its
sparsity pattern and value maps are buffers, its inputs the value
vectors (P_val, q, A_val, l, u).
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch

from . import admm
from . import constants as con
from . import flow
from . import linsys as linsys_registry
from .batch import BatchSolveResults, _postprocess, _prepare
from .solver import Settings, make_config, reject_time_based_rho, torch_dtype, validate_settings
from .sparse_ops import ELLMatrix, ell_gather_values, ell_pattern_from_scipy, ell_value_maps
from .types import DynSettings

# The program's outputs, in order (the JAX package's calling convention).
FIELDS = BatchSolveResults._fields
# Iterations of a turn of the loop where no check is scheduled.
_TURN = 25


def _masked_check(cfg, data, scl, dyn, c: admm.Carry, live) -> admm.Carry:
    """The check at ``c.k`` where ``live`` (``k <= max_iter``), else no
    change: the instances outside it are not active for the check and
    keep their mask."""
    out = admm._apply_check(cfg, data, scl, dyn, replace(c, active=c.active & live), c.k)
    return replace(out, active=out.active | (c.active & ~live))


def turn_plan(cfg) -> tuple[int, frozenset]:
    """(iterations a turn, the places in a turn where a rho update can
    fall).  A turn starts at k = 1 + L t; k = 1 + L t + j is a multiple of
    the interval for some t iff gcd(L, interval) divides j + 1."""
    check = int(cfg.check_termination)
    interval = int(cfg.adaptive_rho_interval) if cfg.adaptive_rho else 0
    L = check or interval or _TURN
    if not interval:
        return L, frozenset()
    g = math.gcd(L, interval)
    return L, frozenset(j for j in range(L) if (j + 1) % g == 0)


def run_loop(cfg, data, scl, dyn, c: admm.Carry) -> admm.Carry:
    """The ADMM iterations from ``c`` (``c.k`` a 0-d int64 tensor) until
    no instance is active or ``k`` passes ``max_iter``."""
    backend = linsys_registry.get(cfg.linsys_solver)
    check = int(cfg.check_termination)
    interval = int(cfg.adaptive_rho_interval) if cfg.adaptive_rho else 0
    L, rho_at = turn_plan(cfg)

    def more(c, data, scl, dyn):
        return (c.k <= cfg.max_iter) & c.active.any()

    def turn(refine):
        def body(c, data, scl, dyn):
            for j in range(L):
                live = c.k <= cfg.max_iter
                c = admm.step(backend, refine, data, dyn, c, c.active & live)
                if check and j == L - 1:
                    c = _masked_check(cfg, data, scl, dyn, c, live)
                if j in rho_at:
                    c = flow.cond((c.k % interval == 0) & live,
                                  lambda c, data, dyn: admm._apply_rho_adaptation(cfg, data, dyn, c),
                                  lambda c, data, dyn: c, (c, data, dyn))
                c = replace(c, k=c.k + 1)
            return c

        return lambda c, data, scl, dyn: flow.while_loop(more, body, c, (data, scl, dyn))

    if not hasattr(backend, "fused_step"):
        return turn(False)(c, data, scl, dyn)
    return flow.cond(backend.refine_signal(c.factor), turn(True), turn(False), (c, data, scl, dyn))


def solve_batch_program(cfg, scaling_iters: int, do_polish: bool, refine_iter: int, P, q, A, l, u, rho0,
                        dyn: DynSettings) -> tuple:
    """The whole batched solve of any backend on dense operands, or of the
    ``cg`` backend on ELL operands, over the whole iteration range, cold
    started, on unscaled inputs (l and u clamped to the finite infinity);
    returns the fields of :data:`FIELDS` in order."""
    sparse = isinstance(P, ELLMatrix) and isinstance(A, ELLMatrix)
    if sparse and linsys_registry.get(cfg.linsys_solver) is not linsys_registry.get("cg"):
        raise ValueError(f"the traced program runs the cg backend on ELL operands, not {cfg.linsys_solver!r}")
    with flow.program():
        scaled, scl, rho_state, factor, it = _prepare(cfg, scaling_iters, P, q, A, l, u, rho0, dyn, None, None)
        c = admm.init_carry(cfg, scaled, rho_state, factor, it)
        c = replace(c, k=torch.ones((), dtype=torch.int64, device=q.device))
        c = run_loop(cfg, scaled, scl, dyn, c)
        fin = admm.finalize(cfg, scaled, scl, dyn, c)
        return tuple(_postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin))


def make_dyn(s: Settings, dtype: torch.dtype) -> DynSettings:
    return DynSettings.make(
        dtype,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )


class SolveProgram(torch.nn.Module):
    """``forward(P, q, A, l, u)`` -> the :data:`FIELDS` tuple, for fixed
    (n, m) and settings (``Settings`` field names; ``dtype`` a name or a
    torch dtype).  The bounds are clamped and rho0 and the runtime
    settings made inside, so a traced program holds them as constants."""

    def __init__(self, n: int, m: int, **settings):
        super().__init__()
        s = Settings(**settings)
        validate_settings(s)
        reject_time_based_rho(s)
        self.settings = s
        self.dtype = torch_dtype(s.dtype)
        self.cfg = make_config(int(n), int(m), s, self.dtype)

    def forward(self, P, q, A, l, u):
        s = self.settings
        if q.dtype != self.dtype:
            raise ValueError(f"this program solves in {self.dtype}, not {q.dtype}")
        clamp = lambda v: torch.clamp(v, -con.OSQP_INFTY, con.OSQP_INFTY)
        rho0 = torch.full((q.shape[0],), s.rho, dtype=self.dtype, device=q.device)
        return solve_batch_program(self.cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter),
                                   P, q, A, clamp(l), clamp(u), rho0, make_dyn(s, self.dtype))


def sparse_operands(P, A) -> dict:
    """The ELL patterns and CSC-nnz -> ELL-slot value maps of the upper
    triangle of P (scipy, (n, n)) and of A (scipy, (m, n)), as plain
    data: for "P" and "A", ``nnz``, ``shape`` and the int32 tensors
    ``pattern`` (idx, t_idx) and ``maps`` (src, t_src)."""
    Pu = sp.triu(sp.csc_matrix(P), format="csc")
    Ac = sp.csc_matrix(A)
    tensors = lambda *arrays: [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]
    out = {}
    for name, M, sym in (("P", Pu, True), ("A", Ac, False)):
        idx, t_idx, shape = ell_pattern_from_scipy(M, sym_from_triu=sym)
        out[name] = dict(nnz=int(M.nnz), shape=list(shape), pattern=tensors(idx, t_idx),
                         maps=tensors(*ell_value_maps(M, sym_from_triu=sym)))
    return out


class SparseSolveProgram(torch.nn.Module):
    """``forward(P_val, q, A_val, l, u)`` -> the :data:`FIELDS` tuple for
    B instances that share a sparsity pattern and the values of P and A:
    ``operands`` as :func:`sparse_operands` gives them (their patterns and
    value maps become buffers, moved with the module), settings as
    ``Settings`` names (the ``cg`` backend).  The operands are assembled
    from the value vectors (``sparse_ops.ell_gather_values``), the bounds
    clamped, rho0 and the runtime settings made inside.  The sparse
    polish's CG cap (``OSQP_TPU_POLISH_CG_CAP``) is read when the program
    is traced, and a traced program keeps it."""

    def __init__(self, operands: dict, B: int = 1, **settings):
        super().__init__()
        s = Settings(**{"linsys_solver": "cg", **settings})
        validate_settings(s)
        reject_time_based_rho(s)
        if linsys_registry.get(s.linsys_solver) is not linsys_registry.get("cg"):
            raise ValueError(f"the sparse program runs the cg backend, not {s.linsys_solver!r}")
        self.settings = s
        self.dtype = torch_dtype(s.dtype)
        self.B = int(B)
        self.shapes = {name: tuple(op["shape"]) for name, op in operands.items()}
        for name, op in operands.items():
            for key, t in zip(("idx", "t_idx", "src", "t_src"), (*op["pattern"], *op["maps"])):
                self.register_buffer(f"{name}_{key}", torch.as_tensor(t, dtype=torch.int32))
        n, m = self.shapes["P"][0], self.shapes["A"][0]
        self.cfg = make_config(n, m, s, self.dtype)

    def _operand(self, name: str, values) -> ELLMatrix:
        """The ELL operand of ``name`` ("P" or "A") with these values."""
        buf = lambda key: getattr(self, f"{name}_{key}")
        return ell_gather_values(buf("idx"), buf("t_idx"), self.shapes[name], buf("src"), buf("t_src"), values,
                                 self.B)

    def forward(self, P_val, q, A_val, l, u):
        s = self.settings
        if q.dtype != self.dtype:
            raise ValueError(f"this program solves in {self.dtype}, not {q.dtype}")
        clamp = lambda v: torch.clamp(v, -con.OSQP_INFTY, con.OSQP_INFTY)
        rho0 = torch.full((self.B,), s.rho, dtype=self.dtype, device=q.device)
        return solve_batch_program(self.cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter),
                                   self._operand("P", P_val), q, self._operand("A", A_val), clamp(l), clamp(u), rho0,
                                   make_dyn(s, self.dtype))

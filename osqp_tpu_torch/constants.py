"""Algorithm constants and status/error codes.

Mirrors the reference OSQP constants exactly (reference:
include/constants.h:17-121).  Every numeric constant here must stay
bit-identical to the reference, otherwise termination / infeasibility
detection diverges on scaled problems (see auxil.c:82,375,495).
"""

from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Solver status (constants.h:17-29)
# ---------------------------------------------------------------------------
OSQP_DUAL_INFEASIBLE_INACCURATE = 4
OSQP_PRIMAL_INFEASIBLE_INACCURATE = 3
OSQP_SOLVED_INACCURATE = 2
OSQP_SOLVED = 1
OSQP_MAX_ITER_REACHED = -2
OSQP_PRIMAL_INFEASIBLE = -3
OSQP_DUAL_INFEASIBLE = -4
OSQP_SIGINT = -5
OSQP_TIME_LIMIT_REACHED = -6
OSQP_NON_CVX = -7
OSQP_UNSOLVED = -10

STATUS_MESSAGE = {
    OSQP_SOLVED: "solved",
    OSQP_SOLVED_INACCURATE: "solved inaccurate",
    OSQP_PRIMAL_INFEASIBLE: "primal infeasible",
    OSQP_PRIMAL_INFEASIBLE_INACCURATE: "primal infeasible inaccurate",
    OSQP_UNSOLVED: "unsolved",
    OSQP_DUAL_INFEASIBLE: "dual infeasible",
    OSQP_DUAL_INFEASIBLE_INACCURATE: "dual infeasible inaccurate",
    OSQP_MAX_ITER_REACHED: "maximum iterations reached",
    OSQP_TIME_LIMIT_REACHED: "run time limit reached",
    OSQP_SIGINT: "interrupted",
    OSQP_NON_CVX: "problem non convex",
}


class ErrorCode(enum.IntEnum):
    """Error codes (constants.h:42-50)."""

    DATA_VALIDATION_ERROR = 1
    SETTINGS_VALIDATION_ERROR = 2
    LINSYS_SOLVER_LOAD_ERROR = 3
    LINSYS_SOLVER_INIT_ERROR = 4
    NONCVX_ERROR = 5
    MEM_ALLOC_ERROR = 6
    WORKSPACE_NOT_INIT_ERROR = 7


ERROR_MESSAGE = {
    ErrorCode.DATA_VALIDATION_ERROR: "data validation error",
    ErrorCode.SETTINGS_VALIDATION_ERROR: "settings validation error",
    ErrorCode.LINSYS_SOLVER_LOAD_ERROR: "linear system solver load error",
    ErrorCode.LINSYS_SOLVER_INIT_ERROR: "linear system solver initialization error",
    ErrorCode.NONCVX_ERROR: "problem non convex",
    ErrorCode.MEM_ALLOC_ERROR: "memory allocation error",
    ErrorCode.WORKSPACE_NOT_INIT_ERROR: "workspace not initialized",
}


class OSQPError(Exception):
    """Exception carrying a reference-compatible error code."""

    def __init__(self, code: ErrorCode, message: str | None = None):
        self.code = ErrorCode(code)
        super().__init__(message or ERROR_MESSAGE[self.code])


class NonConvexError(OSQPError):
    def __init__(self, message: str | None = None):
        super().__init__(ErrorCode.NONCVX_ERROR, message)


# ---------------------------------------------------------------------------
# Default settings (constants.h:58-121)
# ---------------------------------------------------------------------------
RHO = 0.1
SIGMA = 1e-6
MAX_ITER = 4000
EPS_ABS = 1e-3
EPS_REL = 1e-3
EPS_PRIM_INF = 1e-4
EPS_DUAL_INF = 1e-4
ALPHA = 1.6

RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_OVER_RHO_INEQ = 1e3
RHO_TOL = 1e-4  # tolerance for detecting an inequality set to equality

DELTA = 1e-6
POLISH = False
POLISH_REFINE_ITER = 3
# Active-set re-guess passes in polish (no reference analogue — the
# reference does exactly one pass, polish.c:212-350; its single guess at
# the eps=1e-3 ADMM point measurably fails on e.g. CVXQP*_S, and 1-3
# re-guess passes recover the true active set: see tools/ref_osqp.py).
POLISH_PASSES = 4
VERBOSE = True

SCALED_TERMINATION = False
CHECK_TERMINATION = 25
WARM_START = True
SCALING = 10

MIN_SCALING = 1e-4
MAX_SCALING = 1e4

OSQP_NAN = float("nan")
OSQP_INFTY = 1e30
OSQP_DIVISION_TOL = 1.0 / OSQP_INFTY

ADAPTIVE_RHO = True
ADAPTIVE_RHO_INTERVAL = 0
ADAPTIVE_RHO_FRACTION = 0.4
ADAPTIVE_RHO_MULTIPLE_TERMINATION = 4
ADAPTIVE_RHO_FIXED = 100
ADAPTIVE_RHO_TOLERANCE = 5.0

TIME_LIMIT = 0.0

PRINT_INTERVAL = 200

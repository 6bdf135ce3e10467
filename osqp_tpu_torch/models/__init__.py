"""QP problem families from the reference documentation (counterpart of
``osqp_tpu/models``).  The MPC and portfolio builders are here; the
other four generators (``huber``, ``lasso``, ``least_squares``, ``svm``)
are ROADMAP queue 1, item 14."""

from .mpc import MPCProblem, build_mpc_qp
from .portfolio import build_portfolio

__all__ = ["MPCProblem", "build_mpc_qp", "build_portfolio"]

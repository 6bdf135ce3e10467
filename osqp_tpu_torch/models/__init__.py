"""QP problem families from the reference documentation (counterpart of
``osqp_tpu/models``, numpy only): the six applications of
docs/examples/{mpc,portfolio,lasso,huber,svm,least_squares}.rst as
dense (P, q, A, l, u) data ready for :func:`osqp_tpu_torch.solve_batch`
or :class:`osqp_tpu_torch.Solver`."""

from .huber import build_huber
from .lasso import build_lasso
from .least_squares import build_least_squares
from .mpc import MPCProblem, build_mpc_qp
from .portfolio import build_portfolio
from .svm import build_svm

__all__ = [
    "MPCProblem",
    "build_mpc_qp",
    "build_lasso",
    "build_huber",
    "build_svm",
    "build_portfolio",
    "build_least_squares",
]

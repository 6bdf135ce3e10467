"""QP problem families from the reference documentation (counterpart of
``osqp_tpu/models``).  The MPC builder is here; the other five
generators are ROADMAP queue 1, item 14."""

from .mpc import MPCProblem, build_mpc_qp

__all__ = ["MPCProblem", "build_mpc_qp"]

"""Problem I/O: QPS (Maros-Meszaros) format parsing (counterpart of
``osqp_tpu/io``, pure Python)."""

from .qps import QPSProblem, load_qps, parse_qps  # noqa: F401

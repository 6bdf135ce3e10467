"""Problem I/O: QPS (Maros-Meszaros) format parsing, with the native C++
parser, and writing (counterpart of ``osqp_tpu/io``)."""

from .qps import QPSProblem, load_qps, parse_qps, parse_qps_fast  # noqa: F401
from .qps_write import write_qps  # noqa: F401

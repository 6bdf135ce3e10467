"""Builds the CUDA kernels in ``csrc/`` and binds them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, at first use on a CUDA tensor.  The
library lands in ``osqp_tpu_torch/_build/`` under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already there.  Nothing is built or
loaded at import: the CPU path never touches the compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
# Bytes of shared memory one block may use on sm_90 (227 KB): the bound
# the wrappers check before a launch.
SMEM_BYTES = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# (name, argument types); every function returns a cudaError_t as int.
_SIGNATURES = {
    "osqp_chol_inverse": (_I, _P, _P, _I, _I, _P),
    "osqp_admm_iter": (_I,) + (_P,) * 19 + (_D, _D, _I, _I, _I, _P),
    "osqp_admm_iter_refined": (_I,) + (_P,) * 21 + (_D, _D, _I, _I, _I, _P),
    "osqp_ruiz": (_I,) + (_P,) * 17 + (_I,) * 6 + (_P,),
    "osqp_term_products": (_I,) + (_P,) * 11 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of osqp_tpu_torch need the CUDA toolkit")
    return path


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    sources = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"libosqp_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in sources if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.osqp_cuda_error_string.argtypes = (_I,)
            lib.osqp_cuda_error_string.restype = ctypes.c_char_p
            lib.osqp_split_geometry.argtypes = (_I, _I, _I, _I, ctypes.POINTER(_I))
            lib.osqp_split_geometry.restype = None
            for name in ("osqp_admm_iter_smem", "osqp_admm_iter_refined_smem"):
                getattr(lib, name).argtypes = (_I, _I, _I)
                getattr(lib, name).restype = ctypes.c_size_t
            _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().osqp_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    """0 for float32, 1 for float64: the launchers' template switch."""
    import torch

    return {torch.float32: 0, torch.float64: 1}[dtype]


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def split_geometry(B: int, n: int, m: int, device) -> tuple[int, int, int]:
    """(column chunks, rows of A per block, rows of P per block) of the
    split kernels (K3, K4) for B instances of n variables and m
    constraints on ``device``, as csrc/common.cuh cuts them."""
    import torch

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    out = (_I * 3)()
    library().osqp_split_geometry(B, n, m, sm_count, out)
    return out[0], out[1], out[2]


def check_smem(kernel: str, dtype, n: int, m: int) -> None:
    """Raise if one block of ``kernel`` (``admm_iter`` or
    ``admm_iter_refined``) needs more shared memory at (n, m) than a block
    may have; the launcher reports the bytes it would take."""
    smem = getattr(library(), f"osqp_{kernel}_smem")(dtype_code(dtype), n, m)
    if smem > SMEM_BYTES:
        raise ValueError(f"{kernel}: n={n}, m={m} needs {smem} bytes of shared memory, above {SMEM_BYTES}")

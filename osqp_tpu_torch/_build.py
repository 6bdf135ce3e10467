"""Builds the CUDA kernels in ``csrc/`` and binds them, with ctypes and
as ``torch.library`` operators.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, at first use on a CUDA tensor: the
live solve calls it through ctypes.  The same objects and
``csrc/torch_ops.cpp`` (compiled against the running torch's headers)
link into a second library, the operators of namespace
``torch.ops.osqp_tpu_torch`` over the dense path's entries, which a
traced program calls (:func:`ops`); ``build(ops=True)`` compiles both in
one wave.  Both land in ``osqp_tpu_torch/_build/`` under names keyed by
a hash of the sources and flags (and, for the operators, of the torch
version and its C++ ABI), beside the kernels' objects, so an edited
source rebuilds and an unchanged one loads what is there.  Nothing is
built or loaded at import: the CPU path never touches the compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
TORCH_OPS = CSRC / "torch_ops.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)
# Bytes of shared memory one block may use on sm_90 (227 KB): K2 sizes
# its largest matrix by it, K1r's resident path its CTA's share.  An SM
# holds 228 KB, of which each resident block reserves 1 KB: K4 sizes its
# cluster shares by these.
SMEM_BYTES = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# (name, argument types); every function returns an int: the launchers
# a cudaError_t, the occupancy queries a count.
_SIGNATURES = {
    "osqp_ruiz_resident_clusters": (_I,) * 4,
    "osqp_chol_inverse_blocks_per_sm": (_I,) * 2,
    "osqp_chol_inverse": (_I, _P, _P, _I, _I, _P),
    "osqp_chol_inverse_leaf": (_I, _P, _P, _I, _I, _P),
    "osqp_chol_inverse_leaf_cluster": (_I, _P, _P, _P, _I, _I, _I, _P),
    "osqp_admm_iter": (_I,) + (_P,) * 20 + (_D, _D, _I, _I, _I, _I, _P),
    "osqp_admm_iter_refined": (_I,) + (_P,) * 22 + (_D, _D, _I, _I, _I, _I, _P),
    "osqp_admm_iter_refined_resident": (_I,) + (_P,) * 21 + (_D, _D) + (_I,) * 6 + (_P,),
    "osqp_admm_iter_refined_resident_clusters": (_I,) * 5,
    "osqp_admm_iter_refined_resident_smem": (_I,) * 5,
    "osqp_ruiz": (_I,) + (_P,) * 17 + (_I,) * 7 + (_P,),
    "osqp_ruiz_sweep_a": (_I,) + (_P,) * 5 + (_I,) * 4 + (_P,),
    "osqp_ruiz_update": (_I,) + (_P,) * 6 + (_I,) * 3 + (_P,),
    "osqp_ruiz_sweep_p": (_I,) + (_P,) * 6 + (_I,) * 4 + (_P,),
    "osqp_ruiz_apply": (_I,) + (_P,) * 5 + (_I,) * 3 + (_P,),
    "osqp_ruiz_apply_vectors": (_I,) + (_P,) * 9 + (_I,) * 3 + (_P,),
    "osqp_term_products": (_I,) + (_P,) * 10 + (_I,) * 5 + (_P,),
    "osqp_kkt_lu_factor": (_I, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "osqp_kkt_lu_factor_blocks": (_I, _P, _P, _P, _D, _I, _I, _P, _P, _P, _I, _I, _P, _P),
    "osqp_kkt_lu_solve_scratch": (_I,) * 3,
    "osqp_kkt_lu_solve": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "osqp_ell_group": (_I, _P) + (_I,) * 6 + (_P,),
    "osqp_ell_cg_start": (_I, _P, _P, _I) + (_P,) * 8 + (_D,) + (_P,) * 3 + (_I,) * 4 + (_P,),
    "osqp_ell_scale": (_I,) + (_P,) * 9 + (_I,) * 5 + (_P,),
    "osqp_cg_parts": (_I,),
    "osqp_cg_step": (_I,) + (_P,) * 15 + (_D, _I, _I, _P),
    "osqp_cg_loop": (_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _D, _D) + (_P,) * 11 + (_I,) * 9 + (_P,),
    "osqp_cg_loop_smem": (_I,) * 9,
    "osqp_cg_loop_clusters": (_I,) * 6,
    "osqp_cg_dense_loop": (_I, _P, _P, _P, _D) + (_P,) * 7 + (_I,) * 9 + (_P,),
    "osqp_cg_dense_loop_smem": (_I,) * 6,
    "osqp_cg_dense_loop_clusters": (_I,) * 6,
    "osqp_bt_factor": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "osqp_bt_solve": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "osqp_bt_quotients": (_I, _P, _P, _P, _I, _P),
}

_lock = threading.Lock()
_lib = None
# The file name of the operators' library loaded in this process (by
# ops(), or from an artifact by export.load_solver), None before.
ops_loaded = None


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


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(cmd, proc, others=()) -> None:
    """Wait for one nvcc; if it failed, stop ``others`` and raise."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        for other in others:
            other.kill()
            other.wait()
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")


def _kernel_sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _kernel_digest() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _kernel_sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def _torch_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) of ``csrc/torch_ops.cpp`` for the
    running torch: its headers and libraries, and its C++ ABI."""
    import torch
    from torch.utils.cpp_extension import include_paths, library_paths

    cflags = ["-std=c++20", "-O2", "-Xcompiler", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    cflags += [f"-I{p}" for p in include_paths()]
    lflags = []
    for p in library_paths():
        lflags += [f"-L{p}", "-Xlinker", f"-rpath={p}"]
    return cflags, lflags + ["-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch_cuda"]


def _ops_digest(kernels: str) -> str:
    import torch

    cflags, lflags = _torch_flags()
    digest = hashlib.sha256(kernels.encode())
    digest.update(torch.__version__.encode())
    digest.update(" ".join(cflags + lflags).encode())
    digest.update(TORCH_OPS.read_bytes())
    return digest.hexdigest()[:16]


def ops_path() -> pathlib.Path:
    """Where the operators' library for these sources and this torch lies."""
    return BUILD_DIR / f"libosqp_torch_ops_{_ops_digest(_kernel_digest())}.so"


def build(ops: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists, and
    with ``ops`` the operators' library too, in the same wave of
    compilers; returns the kernels' library.  The objects stay beside the
    libraries, so a later :func:`build_ops` compiles only torch_ops.cpp."""
    kernels = _kernel_digest()
    out = BUILD_DIR / f"libosqp_kernels_{kernels}.so"
    ops_out = BUILD_DIR / f"libosqp_torch_ops_{_ops_digest(kernels)}.so" if ops else None
    if out.exists() and (ops_out is None or ops_out.exists()):
        return out
    obj_dir = BUILD_DIR / f"objects_{kernels}"
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    units = [p for p in _kernel_sources() if p.suffix == ".cu"]
    objects = [obj_dir / f"{p.stem}.o" for p in units]
    jobs = []
    if not all(o.exists() for o in objects):
        jobs += [[nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{p.stem}.o"), str(p)] for p in units]
        objects = [work / f"{p.stem}.o" for p in units]
    if ops_out is not None:
        cflags, lflags = _torch_flags()
        jobs.append([nvcc, *cflags, "-c", "-o", str(work / "torch_ops.o"), str(TORCH_OPS)])
    try:
        procs = [_start(cmd) for cmd in jobs]
        for cmd, proc in zip(jobs, procs):
            _finish(cmd, proc, procs)
        if not out.exists():
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / out.name), *(str(o) for o in objects)]
            _finish(link, _start(link))
            os.replace(work / out.name, out)
        if ops_out is not None:
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / ops_out.name), *(str(o) for o in objects),
                    str(work / "torch_ops.o"), *lflags]
            _finish(link, _start(link))
            os.replace(work / ops_out.name, ops_out)
        if objects[0].parent == work and not obj_dir.exists():
            keep = BUILD_DIR / f"{obj_dir.name}.{os.getpid()}.tmp"
            keep.mkdir()
            for o in objects:
                os.replace(o, keep / o.name)
            try:
                os.replace(keep, obj_dir)
            except OSError:  # another process kept its objects first
                shutil.rmtree(keep, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def build_ops() -> pathlib.Path:
    """The operators' library, built unless it exists (with the kernels'
    objects, compiled unless kept)."""
    build(ops=True)
    return ops_path()


def ops():
    """``torch.ops.osqp_tpu_torch``, its library loaded (built at first
    use).  Where an artifact's library is loaded already
    (``export.load_solver``), it serves: both are made from the same
    sources by the same torch, or the artifact refused to load."""
    global ops_loaded
    import torch

    if ops_loaded is None:
        with _lock:
            if ops_loaded is None:
                path = build_ops()
                torch.ops.load_library(str(path))
                ops_loaded = path.name
    return torch.ops.osqp_tpu_torch


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
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
            for name in ("osqp_admm_iter_scratch", "osqp_admm_iter_refined_scratch"):
                getattr(lib, name).argtypes = (_I,) * 5
                getattr(lib, name).restype = ctypes.c_size_t
            lib.osqp_chol_inverse_leaf_scratch.argtypes = (_I,)
            lib.osqp_chol_inverse_leaf_scratch.restype = ctypes.c_longlong
            lib.osqp_kkt_lu_factor_scratch.argtypes = (_I,) * 3
            lib.osqp_kkt_lu_factor_scratch.restype = ctypes.c_longlong
            lib.osqp_term_products_scratch.argtypes = (_I,) * 7
            lib.osqp_term_products_scratch.restype = ctypes.c_longlong
            lib.osqp_cg_dense_loop_scratch.argtypes = (_I,) * 6
            lib.osqp_cg_dense_loop_scratch.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def tracing(t=None) -> bool:
    """True under ``torch.export`` or ``torch.compile``, or where ``t`` is
    a FakeTensor: a wrapper then calls its ``torch.library`` operator
    (:func:`ops`) on a CUDA tensor, in place of a ctypes launch."""
    import torch

    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return True
    if t is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def setting(v):
    """A setting (sigma, alpha, K8's shift) as the operators take it: a
    one-element tensor; a number becomes a float64 one on the host."""
    import torch

    return v if isinstance(v, torch.Tensor) else torch.tensor(float(v), dtype=torch.float64)


def check(code: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().osqp_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def dtype_code(dtype) -> int:
    """0 for float32, 1 for float64: the launchers' template switch."""
    import torch

    return {torch.float32: 0, torch.float64: 1}[dtype]


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index``, as :func:`stream` gives
    it for the current device, by the call PyTorch's generated kernels make
    (torch._inductor's get_raw_stream): no Stream object is built, which
    saves a few microseconds a launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The number of SMs of the CUDA ``device``."""
    import torch

    device = torch.device(device)
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def split_geometry(B: int, n: int, m: int, device) -> tuple[int, int, int]:
    """(column chunks, rows of A per block, rows of P per block) of the
    split kernels (K3, K4) for B instances of n variables and m
    constraints on ``device``, as csrc/common.cuh cuts them."""
    out = (_I * 3)()
    library().osqp_split_geometry(B, n, m, sm_count(device), out)
    return out[0], out[1], out[2]


def scratch(kernel: str, dtype, B: int, n: int, m: int, device):
    """The scratch buffer that ``kernel`` (``admm_iter`` or
    ``admm_iter_refined``) takes at (B, n, m) on ``device``, sized by the
    library, and the device's SM count that sized it."""
    import torch

    sms = sm_count(device)
    nbytes = getattr(library(), f"osqp_{kernel}_scratch")(dtype_code(dtype), B, n, m, sms)
    return torch.empty(nbytes, dtype=torch.uint8, device=device), sms

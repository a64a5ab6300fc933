"""Build and load the port's two native libraries.

``csrc/uniform_sweep.cu`` (the CUDA sweep kernels) is compiled by nvcc and
``csrc/bdd_host.cpp`` (host preprocessing and the OpenMP CPU solver) by g++,
each into a shared library with a plain C interface, bound with ctypes (no
PyTorch headers, so a build takes seconds). A library lands in
``bdd_tpu_torch/build/`` under a name keyed by a hash of its source and flags,
and is built at first use. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "uniform_sweep.cu")
HOST_SOURCE = os.path.join(_PKG, "csrc", "bdd_host.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

# No --use_fast_math: it breaks isinf/isnan, which the ±inf forcing contract
# needs. -fmad=false: no a*b+c contraction into FMA, so the kernels round
# exactly like the torch twins (bit-equal results are expected).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]
HOST_FLAGS = ["-O2", "-std=c++17", "-fopenmp", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH")
    return path


def nvcc_command(nvcc: str, out: str, extra: Optional[List[str]] = None) -> List[str]:
    return [nvcc, *NVCC_FLAGS, *(extra or []), "-o", out, SOURCE]


def _library_path(stem: str, source: str, flags: List[str]) -> str:
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def library_path() -> str:
    return _library_path("uniform_sweep", SOURCE, NVCC_FLAGS)


def host_library_path() -> str:
    return _library_path("bddhost", HOST_SOURCE, HOST_FLAGS)


def _compile(out: str, command: Callable[[str], List[str]]) -> str:
    """Run ``command(tmp)`` unless ``out`` exists, then rename into place."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders see whole files
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build() -> str:
    """Compile the kernel library unless this source+flags version exists."""
    return _compile(library_path(), lambda tmp: nvcc_command(nvcc_path(), tmp))


def build_host() -> str:
    """Compile the host library unless this source+flags version exists."""
    return _compile(
        host_library_path(),
        lambda tmp: [_gxx_path(), *HOST_FLAGS, "-o", tmp, HOST_SOURCE],
    )


def build_all() -> Dict[str, str]:
    """Both libraries, the two compilers started together."""
    out: Dict[str, object] = {}

    def run(name: str, fn: Callable[[], str]) -> None:
        try:
            out[name] = fn()
        except BaseException as exc:  # re-raised below, in the caller's thread
            out[name] = exc

    threads = [
        threading.Thread(target=run, args=("kernels", build)),
        threading.Thread(target=run, args=("host", build_host)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in out.values():
        if isinstance(v, BaseException):
            raise v
    return {k: str(v) for k, v in out.items()}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # (table, nr_buckets, nr_blocks, tile, pmax, smem_bytes, arcs, lo, hi,
    #  din_lo, din_hi, alpha, omega_arr, omega, frontier in, out_lo, out_hi,
    #  out_mm, frontier out, stream); the wide entries read tile as the
    # warps a block and pmax as the values a shared-memory row, the huge
    # entries tile as the threads a block and take after smem_bytes the ring
    # form's hops (0: the grouped body); the huge entries' counting forms
    # ("_count") take the pair of accumulators before the stream
    sig = [vp, i, i, i, i, i] + [vp] * 7 + [d] + [vp] * 6
    huge_sig = sig[:6] + [i] + sig[6:]
    for suffix in ("f32", "f64"):
        for name in ("uniform_forward", "uniform_backward", "uniform_backward_run",
                     "uniform_forward_wide", "uniform_backward_wide",
                     "uniform_backward_run_wide"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = sig, i
        for name in ("uniform_forward_huge", "uniform_backward_huge",
                     "uniform_backward_run_huge"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = huge_sig, i
            f = getattr(lib, f"{name}_count_{suffix}")
            f.argtypes, f.restype = huge_sig[:-1] + [vp, vp], i
        # the card's answer for the blocks an SM holds of the huge entries
        # and of their counting forms: (threads, smem_bytes, hops, out)
        for name in ("uniform_huge_occupancy", "uniform_huge_count_occupancy"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = [i, i, i, ctypes.POINTER(ctypes.c_int)], i
    # the L2 body's entries: (table, nr_buckets, nr_blocks, threads, split,
    #  nr_columns, arcs, lo, hi, din_lo, din_hi, alpha, omega_arr, omega,
    #  frontier in, out_lo, out_hi, out_mm, frontier out, rows, partials,
    #  counters, stream), their counting forms ("_count": the pair of
    #  accumulators before the stream), and the card's answer for the blocks
    #  an SM holds of each: (threads, out)
    huge = [vp, i, i, i, i, i] + [vp] * 7 + [d] + [vp] * 9
    for suffix in ("f32", "f64"):
        for name in ("uniform_forward_huge_l2", "uniform_backward_huge_l2",
                     "uniform_backward_run_huge_l2"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = huge, i
            f = getattr(lib, f"{name}_count_{suffix}")
            f.argtypes, f.restype = huge + [vp], i
        for name in ("uniform_huge_l2_occupancy", "uniform_huge_l2_count_occupancy"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = [i, ctypes.POINTER(ctypes.c_int)], i
    # the cluster body's entries: (table, nr_buckets, nr_blocks, threads,
    #  cluster, pmax, smem_bytes, arcs, ..., frontier out, stream), and the
    #  card's answer for its clusters: (cluster, threads, smem_bytes, pmax,
    #  out)
    cluster = [vp, i, i, i, i, i, i] + [vp] * 7 + [d] + [vp] * 6
    for suffix in ("f32", "f64"):
        for name in ("uniform_forward_huge_cluster", "uniform_backward_huge_cluster",
                     "uniform_backward_run_huge_cluster"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes, f.restype = cluster, i
        f = getattr(lib, f"uniform_huge_cluster_occupancy_{suffix}")
        f.argtypes, f.restype = [i, i, i, i, ctypes.POINTER(ctypes.c_int)], i


def load() -> ctypes.CDLL:
    """The kernel library, built at first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _LIB = lib
    return _LIB

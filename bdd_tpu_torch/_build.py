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


class Launch(ctypes.Structure):
    """The library's record of one launch of a sweep body (uniform_sweep.cu,
    ``Launch``; ``layout.BodyLaunch`` with its L2 scratch and counting
    accumulator)."""

    _fields_ = [("table", ctypes.c_void_p), ("body", ctypes.c_int), ("nr_buckets", ctypes.c_int),
                ("blocks", ctypes.c_int), ("threads", ctypes.c_int),
                ("smem_forward", ctypes.c_int), ("smem_backward", ctypes.c_int),
                ("own", ctypes.c_int * 2), ("rows", ctypes.c_void_p),
                ("partials", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("acc", ctypes.c_void_p)]


class Buffers(ctypes.Structure):
    """The buffers of a half-sweep or a run (uniform_sweep.cu, ``Buffers``)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "arcs", "lo", "hi", "din_lo", "din_hi", "alpha", "omega_arr")] + [
        ("omega", ctypes.c_double)] + [(name, ctypes.c_void_p) for name in (
            "frontier", "out_lo", "out_hi", "out_mm", "out_frontier")]


def _declare(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    for suffix in ("f32", "f64"):
        # (records, n, buffers, stream, index of the first record that failed)
        for name in ("uniform_forward", "uniform_backward", "uniform_backward_run"):
            f = getattr(lib, f"{name}_{suffix}")
            f.argtypes = [ctypes.POINTER(Launch), i, ctypes.POINTER(Buffers), ctypes.c_void_p,
                          ctypes.POINTER(i)]
            f.restype = i
        # (body, threads, smem_bytes, own0, own1, counting, out)
        f = getattr(lib, f"uniform_occupancy_{suffix}")
        f.argtypes, f.restype = [i] * 6 + [ctypes.POINTER(i)], i


def load() -> ctypes.CDLL:
    """The kernel library, built at first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _LIB = lib
    return _LIB

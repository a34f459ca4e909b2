"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``),
and the port's host C++ libraries (``native/*.cpp``).

Each source compiles to an object with ``nvcc`` for ``sm_90a``, all in
parallel, and the objects link into one shared library with a plain C
interface that :mod:`ctypes` loads.  No source includes PyTorch's headers,
so a cold build takes seconds.  The library lands in
``build/srtb_tpu_torch/`` at the root of the checkout, named by a hash of
the sources and flags: an edited source rebuilds, an unchanged one is
reused.  Nothing is built when the package is imported — only at the
first kernel launch, or by calling :func:`build`.

:func:`build_host_library` takes the same route for host code: the host
C++ compiler (``$CXX``, else ``g++``) builds a source of ``native/`` into
a shared library beside the kernels', named by the source's hash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srtb_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
HOST_CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F32, _F64 = ctypes.c_float, ctypes.c_double
# every exported function returns cudaGetLastError() after its launch
_SIGNATURES = {
    "srtb_unpack_subbyte_window": (_P, _P, _P, _I64, _I32, _P),
    "srtb_rfi_s1_dedisperse": (_P, _P, _P, _P, _I64, _F32, _F64, _F64,
                               _F64, _F64, _P),
    "srtb_sk_stats": (_P, _P, _P, _P, _I64, _I64, _P),
    "srtb_sk_apply_timeseries": (_P, _P, _P, _P, _I64, _I64, _P),
    "srtb_unpack_subbyte_planes_window": (_P, _P, _P, _I64, _I32, _P),
    "srtb_fft_rows_geometry": (_I64, _P),
    "srtb_fft_rows": (_P, _P, _I64, _I64, _I32, _P),
    "srtb_fft_rows_stats_geometry": (_I64, _P),
    "srtb_fft_rows_stats": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _P),
    "srtb_fft_rows_skzap_geometry": (_I64, _P),
    "srtb_fft_rows_skzap": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32,
                            _I64, _F32, _F32, _P),
    "srtb_dedisperse": (_P, _P, _I64, _I64, _F64, _F64, _F64, _F64, _P),
    "srtb_fft2_pass1": (_P, _P, _P, _I64, _I64, _I64, _I32, _P),
    "srtb_fft2_pass1_geometry": (_I64, _P),
    "srtb_fft2_pass1_front_geometry": (_I64, _P),
    "srtb_fft2_pass2": (_P, _P, _I64, _I64, _I32, _P),
    "srtb_fft2_pass1_front": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                              _I32, _I32, _P),
    "srtb_fft2_pass2_spectrum_geometry": (_I64, _P),
    "srtb_fft2_pass2_spectrum": (_P, _P, _P, _P, _P, _P, _I64, _I64, _F32,
                                 _I32, _F64, _F64, _F64, _F64, _P),
}


class KernelBuildError(RuntimeError):
    """The kernel library did not build (``nvcc`` missing, a source that
    does not compile or link): a ``compile`` device fault to the error
    taxonomy (``resilience/errors.py``), which the engine escalates as a
    ``KernelFault`` and never demotes."""


class KernelLaunchError(RuntimeError):
    """A launch function reported a CUDA error: ``code`` is the
    ``cudaError_t`` value and ``cuda_name`` its ``cudaGetErrorName``
    (``resilience/errors.py`` classifies by the name)."""

    def __init__(self, kernel: str, code: int, cuda_name: str):
        super().__init__(f"{kernel}: CUDA error {code} ({cuda_name}) at "
                         "launch")
        self.kernel = kernel
        self.code = int(code)
        self.cuda_name = cuda_name


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "port's CUDA kernels cannot be built on this "
                           "machine")


def _sources() -> tuple[list[Path], str]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return sources, digest.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not built yet)
    and return its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers and spills per kernel."""
    sources, digest = _sources()
    lib = BUILD_DIR / f"libsrtb_tpu_torch_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        procs = []
        try:
            for src in sources:
                cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src),
                       "-o", str(tmp / (src.stem + ".o"))]
                procs.append((src, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, proc in procs:
                out, _ = proc.communicate()
                if verbose and out:
                    print(out, end="", flush=True)
                if proc.returncode:
                    failed.append(f"{src.name}:\n{out}")
        finally:
            for _src, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        objs = [str(tmp / (src.stem + ".o")) for src in sources]
        out_so = tmp / lib.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                              str(out_so), *objs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode:
            raise KernelBuildError(f"nvcc link failed:\n{res.stdout}")
        os.replace(out_so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _host_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, g++): the port's "
                           "native libraries cannot be built here")
    return cxx


def build_host_library(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with the host C++ compiler into
    ``build/srtb_tpu_torch/lib<name>_<hash>.so`` (if not built yet) and
    return its path; raises when the compiler fails."""
    src = NATIVE_DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode()
                            + src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        out_so = tmp / lib.name
        res = subprocess.run([_host_cxx(), *HOST_CXX_FLAGS, str(src), "-o",
                              str(out_so)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"host build of {src.name} failed:\n"
                               f"{res.stdout}")
        os.replace(out_so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.srtb_cuda_error_name.argtypes = [_I32]
    lib.srtb_cuda_error_name.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelLaunchError` when a launch function reports a
    CUDA error (a refused launch never runs, and a later synchronize
    would not report it)."""
    if rc != 0:
        cuda_name = library().srtb_cuda_error_name(rc).decode()
        raise KernelLaunchError(name, rc, cuda_name)


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, which
    every kernel launches on (no synchronisation of its own)."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_contiguous(name: str, **tensors) -> None:
    """Raise unless every given tensor lies on one CUDA device and is
    contiguous — the kernels take raw pointers and assume both."""
    devices = set()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def check_out(out, dtype, shape: tuple, device) -> None:
    """Raise unless ``out``, when given, is a ``dtype`` tensor of
    ``shape`` on ``device``: the caller's buffer (a stream's row of an
    [S, ...] tensor) that a kernel's wrapper writes its result into."""
    if out is not None and (out.dtype != dtype
                            or tuple(out.shape) != tuple(shape)
                            or out.device != device):
        raise ValueError(f"out must be {dtype} {list(shape)} on {device}")

"""Typed error taxonomy for the streaming runtime (port of
``srtb_tpu/resilience/errors.py``).

Every recovery decision dispatches on one question: what kind of failure
is this?

- ``TRANSIENT``: the operation may succeed if re-run (an interrupted
  read, a momentarily unavailable socket).  Retried with backoff by
  :mod:`srtb_tpu_torch.resilience.retry`.
- ``DATA_LOSS``: retried like a transient, and counted in
  ``data_loss_total``: loss is never silent.
- ``FATAL``: retrying cannot help (programming errors, escalations).
  Propagates to a clean shutdown.
- ``DEVICE``: the card failed in a way plain retry cannot fix but the
  plan-demotion ladder and the device reinit may
  (:mod:`srtb_tpu_torch.resilience.demote`): an out-of-memory (the same
  chain allocates the same bytes again; a cheaper plan may fit), a kernel
  library that does not build or a kernel the card refuses to launch
  (deterministic for the same plan), or a fault that kills the CUDA
  context (an illegal address, a device-side assert).  Never retried.

Unknown exceptions are FATAL: retrying an unclassified failure hides
bugs.

:func:`classify_device` reads what torch and the port's kernels raise,
gated on the exception's TYPE (as the reference gates its strings on
XLA's runtime type): ``torch.cuda.OutOfMemoryError`` is ``oom``; the
kernel library's :class:`~srtb_tpu_torch.kernels.build.KernelBuildError`
is ``compile``; a :class:`~srtb_tpu_torch.kernels.build.KernelLaunchError`
by its CUDA error name; and torch's own CUDA errors by their message.
Torch 2.11 (the card's, checked by ``chip_smoke.py``'s resilience phase)
raises ``torch.AcceleratorError``, a ``RuntimeError`` subclass, for an
asynchronous CUDA error such as a device-side assert or an illegal
address, at the next synchronizing call; older torch raises a plain
``RuntimeError`` with the same "CUDA error: ..." message, which the type
gate also accepts.  A ``ValueError`` that mentions "out of memory" stays
FATAL.

The ladder's lower rungs do some kernels' work in plain PyTorch or a
library call (the ``monolithic`` rung runs ``torch.fft`` where B9/B10 ran),
so a real build or launch fault of the port's own kernels, though
classified ``compile`` (or ``oom``), is not demoted: the engine escalates
it as :class:`KernelFault`, naming the kernel (:func:`kernel_fault`).  An
out-of-memory from the allocator still demotes, as the reference's does.

A ``halt`` (an illegal address, a device-side assert, a launch failure)
leaves the CUDA context dead for the life of the process: the engine's
reinit rebuilds the processor as the reference does, but a re-dispatch
on the dead context fails again, the reinit budget is spent, and the run
escalates with :class:`ReinitBudgetExceeded`.  Recovery from a sticky
fault is the next process, resuming from the checkpoint
(``checkpoint_path`` / ``run_manifest_path``).
"""

from __future__ import annotations

import errno

TRANSIENT = "transient"
FATAL = "fatal"
DATA_LOSS = "data_loss"
DEVICE = "device"

# device-fault kinds, from the cheapest recovery to the heaviest:
# oom/compile demote the plan, halt reinitializes the processor
DEVICE_OOM = "oom"
DEVICE_COMPILE = "compile"
DEVICE_HALT = "halt"
DEVICE_KINDS = (DEVICE_OOM, DEVICE_COMPILE, DEVICE_HALT)


class PipelineError(Exception):
    """Base of the taxonomy; ``category`` drives every retry, restart
    and escalation decision."""

    category = FATAL


class TransientError(PipelineError):
    """Retryable: re-running the operation may succeed."""

    category = TRANSIENT


class FatalError(PipelineError):
    """Not retryable: escalate to a clean shutdown."""

    category = FATAL


class DataLossError(PipelineError):
    """Retryable, but data was lost or corrupted: counted in
    ``data_loss_total`` even when the retry succeeds."""

    category = DATA_LOSS


class SegmentTimeout(TransientError):
    """An in-flight segment exceeded the deadline."""


class WatchdogEscalation(FatalError):
    """A segment stayed wedged through every allowed requeue."""


class RestartBudgetExceeded(FatalError):
    """A supervised worker crashed more times than its budget allows
    within the window."""


class DeviceFault(PipelineError):
    """A compute-side failure the ladder may recover: ``kind`` is one of
    :data:`DEVICE_KINDS`."""

    category = DEVICE
    kind = DEVICE_HALT


class DeviceOOM(DeviceFault):
    """The plan's device memory does not fit."""

    kind = DEVICE_OOM


class CompileFault(DeviceFault):
    """A kernel build or launch-configuration failure: deterministic for
    the same plan."""

    kind = DEVICE_COMPILE


class DeviceHalt(DeviceFault):
    """The CUDA context died mid-run."""

    kind = DEVICE_HALT


class LadderExhausted(FatalError):
    """A device fault persisted through every demotion rung."""


class ReinitBudgetExceeded(FatalError):
    """The device kept halting past ``device_reinit_max`` reinits in the
    window."""


class KernelFault(FatalError):
    """One of the port's own kernels did not build, or the card refused
    to launch it.  The ladder's lower rungs do some kernels' work in plain
    PyTorch or a library call, and no rung may stand in for a kernel that
    fails, so such a fault escalates here, naming the kernel, and never
    demotes (see :func:`kernel_fault`)."""


# the tag the fault plan puts on every exception it raises
# (``resilience/faults.py``)
INJECTED_TAG = "[injected fault at "


_TRANSIENT_ERRNOS = frozenset(
    e for e in (
        getattr(errno, name, None)
        for name in ("EINTR", "EAGAIN", "EWOULDBLOCK", "EBUSY",
                     "ENOBUFS", "ETIMEDOUT", "ECONNRESET",
                     "ECONNREFUSED", "ENETUNREACH", "EHOSTUNREACH"))
    if e is not None)

# CUDA runtime error names (cudaGetErrorName) by kind
_CUDA_OOM = ("cudaErrorMemoryAllocation",)
_CUDA_COMPILE = ("cudaErrorInvalidDeviceFunction",
                 "cudaErrorNoKernelImageForDevice", "cudaErrorInvalidPtx",
                 "cudaErrorUnsupportedPtxVersion",
                 "cudaErrorLaunchOutOfResources")
_CUDA_HALT = ("cudaErrorIllegalAddress", "cudaErrorLaunchFailure",
              "cudaErrorMisalignedAddress", "cudaErrorIllegalInstruction",
              "cudaErrorHardwareStackError", "cudaErrorECCUncorrectable",
              "cudaErrorAssert")

# torch's messages for the same errors (cudaGetErrorString), which torch
# puts after "CUDA error: ", and the CUDA libraries' allocation failures
_OOM_MARKERS = ("out of memory", "CUFFT_ALLOC_FAILED",
                "CUBLAS_STATUS_ALLOC_FAILED")
_COMPILE_MARKERS = ("no kernel image is available",
                    "invalid device function", "a PTX JIT compilation failed",
                    "unsupported PTX version",
                    "too many resources requested for launch")
_HALT_MARKERS = ("an illegal memory access was encountered",
                 "device-side assert triggered", "unspecified launch failure",
                 "misaligned address", "an illegal instruction was encountered",
                 "hardware stack error", "uncorrectable ECC error")


def _kind_of_cuda_name(name: str) -> str | None:
    if name in _CUDA_OOM:
        return DEVICE_OOM
    if name in _CUDA_COMPILE:
        return DEVICE_COMPILE
    if name in _CUDA_HALT:
        return DEVICE_HALT
    return None


def _is_torch_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` is torch's CUDA runtime speaking: an
    ``AcceleratorError`` (torch >= 2.8) or a ``RuntimeError`` raised by
    torch itself (the exact type, or one whose class lives in torch)."""
    for klass in type(exc).__mro__:
        if klass.__name__ == "AcceleratorError":
            return True
        mod = getattr(klass, "__module__", "") or ""
        if mod == "torch" or mod.startswith("torch."):
            return True
    return type(exc) is RuntimeError


def classify_device(exc: BaseException) -> str | None:
    """Device-fault kind of ``exc`` (:data:`DEVICE_KINDS`), or None when
    it is not a device fault."""
    if isinstance(exc, DeviceFault):
        return exc.kind
    if isinstance(exc, PipelineError):
        return None  # typed errors already chose their category
    # imported here: the taxonomy must not build the kernel library
    from srtb_tpu_torch.kernels.build import (KernelBuildError,
                                              KernelLaunchError)
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return DEVICE_OOM
    if isinstance(exc, KernelBuildError):
        return DEVICE_COMPILE
    if isinstance(exc, KernelLaunchError):
        return _kind_of_cuda_name(exc.cuda_name)
    if not _is_torch_cuda_error(exc):
        return None
    msg = str(exc)
    if not any(m in msg for m in ("CUDA", "cuda", "CUFFT", "cuFFT",
                                  "CUBLAS")):
        return None
    for name in _CUDA_OOM + _CUDA_COMPILE + _CUDA_HALT:
        if name in msg:
            return _kind_of_cuda_name(name)
    if any(m in msg for m in _OOM_MARKERS):
        return DEVICE_OOM
    if any(m in msg for m in _COMPILE_MARKERS):
        return DEVICE_COMPILE
    if any(m in msg for m in _HALT_MARKERS):
        return DEVICE_HALT
    return None


def kernel_fault(exc: BaseException) -> KernelFault | None:
    """The escalation for a real build or launch fault of the port's own
    kernels (a :class:`KernelBuildError`, or a :class:`KernelLaunchError`
    whose code is ``oom`` or ``compile``), or None.  A launch that reports
    a ``halt`` code met a dead context and takes the reinit like any
    other halt; the fault plan's tagged ``compile_fail`` keeps the
    reference's demotion, so the ladder can be walked in tests."""
    from srtb_tpu_torch.kernels.build import (KernelBuildError,
                                              KernelLaunchError)
    if INJECTED_TAG in str(exc):
        return None
    if isinstance(exc, KernelBuildError):
        return KernelFault(f"the kernel library did not build: {exc}")
    if (isinstance(exc, KernelLaunchError)
            and _kind_of_cuda_name(exc.cuda_name) in (DEVICE_OOM,
                                                      DEVICE_COMPILE)):
        return KernelFault(f"kernel {exc.kernel} did not launch "
                           f"({exc.cuda_name}): {exc}")
    return None


def classify(exc: BaseException) -> str:
    """Map any exception to a category: typed errors carry their own;
    recognized device faults are DEVICE; the standard library's
    momentary-condition types are TRANSIENT; everything else FATAL."""
    if isinstance(exc, PipelineError):
        return exc.category
    if classify_device(exc) is not None:
        return DEVICE
    if isinstance(exc, (TimeoutError, InterruptedError,
                        BlockingIOError, ConnectionError)):
        return TRANSIENT
    if isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS:
        return TRANSIENT
    return FATAL

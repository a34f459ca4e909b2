"""Opt-in runtime sanitizer for the pipeline (``Config.sanitize``; port of
``srtb_tpu/analysis/sanitizer.py``).

It traps hazard behavior on a live run, trading throughput for trapping,
at zero cost when disabled (the pipeline holds ``None`` and never calls
in here, and nothing is patched):

- **implicit device->host transfers**: for the run's device, the
  ``torch.Tensor`` methods that read a tensor back to the host
  (``__array__``, so ``np.asarray``/``np.array`` too, ``numpy``,
  ``item``, ``tolist``, and ``cpu``/``to`` from the card to the CPU)
  raise :class:`SanitizerError`, unless the calling thread is inside
  :func:`allow_transfers`: the port's sanctioned fetches
  (``io/writers.to_host``, the dispatch's result copies, the sinks'
  waterfall copies) take it.  On a CPU run the run's device is the CPU,
  so the wrapper enforces the call pattern there as the reference's numpy
  wrapper does on CPU CI.  On the card the device pipe's dispatch also
  runs under ``torch.cuda.set_sync_debug_mode("error")``
  (:meth:`Sanitizer.dispatch_scope`): the mode is process-wide, so the
  armed dispatch and every sanctioned fetch hold one lock, and a fetch
  disarms the mode for its own thread's duration (the chain's boundary
  checks read a flag inside the dispatch);
- **NaN/Inf tripwires** at plan boundaries (:func:`check_finite`: a
  device leaf is reduced on the device, only a flag crosses), and
  **shape/dtype contract asserts** between stages
  (:func:`check_contract`);
- **thread-ownership guards**: engine state names are claimed by the
  first accessing thread and asserted on every later access
  (:meth:`Sanitizer.assert_owner`);
- **leaked-thread check**: a run must end with every thread it spawned
  joined (``utils/termination.leaked_threads``).

The reference's use-after-donate expiry has no counterpart: the port
never donates an input (its ``plan_signature`` marks ``donate_input`` as
the JAX package's).

Sanitized dispatches serialize (every boundary check waits for the
card), so ``Config.sanitize`` is a debugging mode, not a production one.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class SanitizerError(AssertionError):
    """A sanitizer tripwire fired.  The message names the stage or state
    and what to do about it."""


# ------------------------------------------------------------------
# the implicit-transfer tripwire (module-level: installed refcounted, so
# nested sanitized pipelines compose; a thread-local allowance, so the
# sanctioned fetches stay allowed)
# ------------------------------------------------------------------

_tls = threading.local()
_install_lock = threading.Lock()
_install_count = 0
# the guarded devices (the runs' devices), each with its count of scopes
_devices: dict[torch.device, int] = {}
_saved: dict = {}
# the armed dispatch and the sanctioned fetches on the card: one at a
# time, so that the process-wide sync-debug mode is armed only while no
# sanctioned fetch runs (reentrant: a boundary check inside the
# dispatch is a fetch of the dispatching thread)
_sync_lock = threading.RLock()
_WRAPPED = ("__array__", "numpy", "item", "tolist", "cpu", "to")


def _allowed() -> bool:
    return getattr(_tls, "allow_transfers", 0) > 0


@contextlib.contextmanager
def allow_transfers():
    """Mark the current thread as performing a sanctioned explicit
    transfer.  Nothing happens without an armed scope; with one on the
    card, the transfer also waits for another thread's armed dispatch
    and runs with the sync-debug mode off."""
    if not _install_count:
        yield
        return
    prev = getattr(_tls, "allow_transfers", 0)
    _tls.allow_transfers = prev + 1
    try:
        if not any(d.type == "cuda" for d in _devices):
            yield
            return
        with _sync_lock:
            mode = torch.cuda.get_sync_debug_mode()
            if mode:
                torch.cuda.set_sync_debug_mode(0)
            try:
                yield
            finally:
                if mode:
                    torch.cuda.set_sync_debug_mode(mode)
    finally:
        _tls.allow_transfers = prev


def _guarded(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device in _devices


def _target_device(t: torch.Tensor, name: str, args, kwargs):
    """Where ``t.<name>(*args, **kwargs)`` puts its result (the tensor's
    own device for a read into host memory)."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "to":
        device = torch._C._nn._parse_to(*args, **kwargs)[0]
        return t.device if device is None else torch.device(device)
    return None


def _wrap(orig, name: str):
    def wrapped(self, *args, **kwargs):
        if _guarded(self) and not _allowed():
            target = _target_device(self, name, args, kwargs)
            # cpu()/to() within the device are no transfer; a read into
            # host memory (numpy, item, ...) always is
            if target is None or (target.type == "cpu"
                                  and self.device.type != "cpu"):
                raise SanitizerError(
                    f"[sanitize] implicit device->host transfer: "
                    f"Tensor.{name}() on a {self.device} tensor of shape "
                    f"{tuple(self.shape)} dtype {self.dtype} — fetch it "
                    "with io.writers.to_host(...) at a sanctioned sync "
                    "point (drain/sink side), never on the dispatch hot "
                    "path")
        return orig(self, *args, **kwargs)
    wrapped.__name__ = name
    wrapped._srtb_sanitize_orig = orig
    return wrapped


def _install_tripwire(device) -> None:
    global _install_count
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _install_lock:
        _devices[device] = _devices.get(device, 0) + 1
        _install_count += 1
        if _install_count > 1:
            return
        for name in _WRAPPED:
            orig = getattr(torch.Tensor, name)
            # (the original, and whether torch.Tensor itself defined it
            # or inherited it from its C base)
            _saved[name] = (orig, name in vars(torch.Tensor))
            setattr(torch.Tensor, name, _wrap(orig, name))


def _uninstall_tripwire(device) -> None:
    global _install_count
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _install_lock:
        left = _devices.get(device, 0) - 1
        if left > 0:
            _devices[device] = left
        else:
            _devices.pop(device, None)
        _install_count -= 1
        if _install_count > 0:
            return
        for name in _WRAPPED:
            orig, own = _saved.pop(name)
            if own:
                setattr(torch.Tensor, name, orig)
            else:
                delattr(torch.Tensor, name)


def patched() -> bool:
    """Whether any tripwire wrapper is installed on ``torch.Tensor``."""
    return any(hasattr(getattr(torch.Tensor, name), "_srtb_sanitize_orig")
               for name in _WRAPPED)


# ------------------------------------------------------------------
# value / contract checks
# ------------------------------------------------------------------

def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _inexact(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() or leaf.is_complex()
    return np.issubdtype(leaf.dtype, np.inexact)


def check_finite(tag: str, tree) -> None:
    """NaN/Inf tripwire over every float/complex leaf of ``tree`` (a
    tensor, array, or tuple/list/dict/NamedTuple of them).  A device
    leaf is reduced on the device; only the flag crosses, through the
    sanctioned fetch."""
    for leaf in _leaves(tree):
        if not _inexact(leaf):
            continue
        if isinstance(leaf, torch.Tensor):
            flag = torch.isfinite(leaf.detach()).all()
            with allow_transfers():
                ok = bool(flag.item())
        else:
            ok = bool(np.isfinite(np.asarray(leaf)).all())
        if not ok:
            raise SanitizerError(
                f"[sanitize] non-finite values at '{tag}' (shape "
                f"{tuple(getattr(leaf, 'shape', ()))}, dtype "
                f"{getattr(leaf, 'dtype', '?')}) — a stage upstream "
                f"of '{tag}' produced NaN/Inf; check the boundary "
                "tripwires before it to bisect, and RFI normalization / "
                "window coefficients first")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_contract(tag: str, arr, *, ndim: int | None = None,
                   lead: int | None = None, dtype=None) -> None:
    """Shape/dtype contract between stages: the port's boundaries carry
    complex64 [streams, ...] (the reference's carry stacked (re, im)
    float32)."""
    if arr is None:
        return
    shape = tuple(getattr(arr, "shape", ()))
    adt = getattr(arr, "dtype", None)
    if ndim is not None and len(shape) != ndim:
        raise SanitizerError(
            f"[sanitize] stage contract broken at '{tag}': expected "
            f"ndim {ndim}, got shape {shape} — a plan change altered "
            "the boundary representation without updating consumers")
    if lead is not None and (not shape or shape[0] != lead):
        raise SanitizerError(
            f"[sanitize] stage contract broken at '{tag}': expected "
            f"leading axis {lead} (streams), got shape {shape}")
    if dtype is not None and _dtype_name(adt) != _dtype_name(dtype):
        raise SanitizerError(
            f"[sanitize] stage contract broken at '{tag}': expected "
            f"dtype {_dtype_name(dtype)}, got {_dtype_name(adt)} — dtype "
            "drift (the port's kernels take fixed dtypes)")


# ------------------------------------------------------------------
# the per-pipeline object
# ------------------------------------------------------------------

class Sanitizer:
    """One pipeline run's sanitizer state (thread owners + run scope).

    The pipeline holds ``None`` when ``Config.sanitize`` is off; every
    hook site is an ``if san is not None``, which is what makes the
    disabled path zero-cost."""

    def __init__(self):
        self._owners: dict[str, tuple[int, str]] = {}
        self._lock = threading.Lock()

    # -- thread ownership

    def assert_owner(self, name: str) -> None:
        """Claim-on-first-use thread ownership: the first thread to
        touch state ``name`` owns it for the run; any other thread
        touching it afterwards is a cross-thread mutation bug."""
        t = threading.current_thread()
        with self._lock:
            owner = self._owners.setdefault(name, (t.ident, t.name))
        if owner[0] != t.ident:
            raise SanitizerError(
                f"[sanitize] thread-ownership violation on '{name}': "
                f"owned by thread '{owner[1]}' but touched from "
                f"'{t.name}' — engine window state is single-owner "
                "by design; route cross-thread work through the sink "
                "pipe or add a lock")

    def release_owners(self) -> None:
        with self._lock:
            self._owners.clear()

    # -- the armed dispatch

    @contextlib.contextmanager
    def dispatch_scope(self, device):
        """The device pipe's dispatch on the card under
        ``set_sync_debug_mode("error")``: a call that synchronizes with
        the card raises :class:`SanitizerError` (on the CPU: nothing to
        arm)."""
        if torch.device(device).type != "cuda":
            yield
            return
        with _sync_lock:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            except RuntimeError as e:
                if "synchronizing CUDA operation" not in str(e):
                    raise
                raise SanitizerError(
                    "[sanitize] implicit device sync in the dispatch: "
                    f"{e} — the dispatch must enqueue only; read results "
                    "at the drain") from e
            finally:
                torch.cuda.set_sync_debug_mode(prev)

    # -- run scope

    @contextlib.contextmanager
    def run_scope(self, device="cpu"):
        """Arm the transfer tripwire for ``device`` and the leaked-thread
        check for the duration of one pipeline run."""
        from srtb_tpu_torch.utils import termination
        snapshot = termination.thread_snapshot()
        _install_tripwire(device)
        try:
            yield self
        finally:
            _uninstall_tripwire(device)
            self.release_owners()
            leaked = termination.leaked_threads(snapshot)
            if leaked:
                names = termination.describe_threads(leaked)
                raise SanitizerError(
                    f"[sanitize] leaked thread(s) after run: {names} "
                    "— every thread spawned during a run must be "
                    "joined on shutdown (see the join audit in "
                    "utils/termination.py)")

"""The segment processor (port of ``srtb_tpu/pipeline/segment.py``).

Device chain, per segment of raw bytes (ref call stack: SURVEY.md §3.2):

  unpack (+window) -> R2C FFT, Nyquist bin dropped -> RFI stage 1 (mean
  power threshold, normalize, manual mask) -> coherent-dedispersion chirp
  -> waterfall backward C2C (+de-window) -> spectral-kurtosis zap -> power
  time series -> boxcar detection

Everything carries the segment's data streams (polarizations) on a
leading axis, [S, ...], as the reference does: the packet format
(``io/formats.py``) names S and the unpack variant that de-interleaves
them (:func:`unpack_streams`).  The FFTs take the stream axis in their
batch (one B6, B9 or B10 launch over every stream); the kernels whose
reference loops over the streams (K1 on a byte-interleaved segment, K2,
B3, K3, K4, B8 and B12) launch once a stream, each stream with its own
stage-1 threshold; B11 reads both streams of the 2-pol interleave in one
launch.

The processor resolves the reference's plan from the same configuration
and environment (``staged_resolves``, ``fused_tail_resolves``,
``front_fuse_resolves``, ``resolve_strategy``, the staged row
implementation, the skzap rule and the waterfall branch choice) and, for
every Pallas kernel that plan runs, runs the port's hand-written
counterpart (``srtb_tpu_torch/kernels``).  Where the reference hands a
stage to XLA the port uses ``torch`` (cuFFT on the card), or a kernel it
already has (K1, B13, K2).  By plan (S = 1; the kernels marked * launch
once a stream):

  plan                      kernels
  fused:pallas+ftail+skzap  B13, B6 (segment-FFT legs), K2* epilogue, B8*
  fused:pallas2+ftail+skzap B13, B9 + B10 (2^24 ... 2^29-point planes;
                            B6 legs below), K2* epilogue, B8*
  fused:pallas              B13, B6, K2*, B7 (rows in the window), K4*
  fused:monolithic          K1*, cuFFT R2C, K2*, B7 + K4* (rows in the
                            window) or cuFFT rows + K3* + K4*
  use_pallas_sk = 0         ... B6 (rows in the window) + plain SK
  staged (n >= 2^30)        K1*, the R2C by the staged row implementation
                            (below), K2*, cuFFT rows, K3* + K4*
  staged, use_pallas = 0    the same R2C, plain stage 1 + manual mask,
                            B3*, cuFFT rows, plain SK and detect
  staged+ftail              the same R2C in its packed form, ending in
                            the K2* epilogue; then straight to the
                            waterfall (cuFFT rows + K3* + K4*, or B8*)
  staged+ftail+ffuse        B11 on the raw bytes, the Parseval mean, B12*
                            (row FFT, Hermitian post, stage 1, mask,
                            chirp), unblock; then the waterfall as above

B13 and the blocked sub-byte R2C serve the ``simple`` format only, as in
the reference; the other formats unpack to sample order.  K1 unpacks
1/2/4-bit ``simple`` segments and, after a torch de-interleave of the
bytes (``unpack.deinterleave_bytes``), each stream of the byte-interleaved
formats at those widths; every other variant and width is torch.

The staged R2C by ``SRTB_STAGED_ROWS_IMPL`` (read with the other two
switches by :func:`staged_env`): ``xla`` (the default) one cuFFT R2C, or
with the fused tail ``pack_even_odd``, one cuFFT C2C and the Hermitian
post; ``pallas`` the pack, the four-step on B6 legs and the Hermitian
post; ``pallas2`` the pack, B9, B10, unblock and the Hermitian post (B6
legs when n/2 lies outside 2^24 ... 2^29, the reference's dispatch by
size).  ``SRTB_STAGED_BLOCKED=1`` (1/2/4 bits) unpacks into B13's planes
instead and finishes with the sub-byte R2C's plane butterfly.

The fused spectrum tail's epilogue is XLA in the reference (no Pallas
kernel); here it is the stage-1 threshold from Parseval over the packed
C2C output (``rfi.mean_power_packed``) and K2 on the assembled spectrum,
whose chirp is exact.  The rule: for every Pallas kernel the reference's
plan runs, the port runs its counterpart; where the reference runs XLA,
the port runs torch or K1, B13 and K2.  So K1 and B13 unpack whatever
``use_pallas`` says, K2 takes stage 1 and the chirp on every plan but
two (without ``use_pallas`` the reference runs XLA and a chirp bank
there; the front-fused plan runs them in B12), and the staged plan
without ``use_pallas`` or the fused tail, whose stage (c) runs the
reference's chirp kernel ``dedisperse_df64`` after an XLA stage 1, runs
the plain stage 1 and B3.  The waterfall rows follow ``use_pallas``.
``fused:four_step`` and ``fused:mxu`` run as ``fused:pallas`` with
cuFFT rows (the reference's ``mxu`` is DFT-matrix matmuls, no Pallas
kernel).  The staged plan's three programs exist to fit a TPU's HBM; the
port runs the same kernels as one chain.  ``staged`` forces the plan as
the reference's argument of that name does.  Settings the port does not
implement yet raise ``NotImplementedError`` naming their ROADMAP item.

Complex data stays ``complex64`` (interleaved), as ``torch.fft`` produces
it; the reference's stacked ``[2, ...]`` (re, im) form is built only by
the tests that compare the two.

Staging (the reference's protocol, used by the runtime's in-flight
engine): :meth:`SegmentProcessor.stage_input` starts the upload of a
segment's bytes from pinned host memory on a copy stream and makes the
compute stream (the caller's current stream) wait for it, so the upload
runs under the previous segment's chain; :meth:`run_device` runs the
chain on the staged bytes.  With the ingest ring (``ingest_ring``, "auto"
whenever overlap-save reserves a byte-aligned tail) only a segment's
stride of new bytes is uploaded: a warm ``stage_input`` copies the
device-resident carry (the previous segment's reserved tail) into the
head of a fresh buffer and uploads the stride into its tail, both on the
copy stream, and :meth:`run_device_ring` runs the chain and returns the
next carry.  The assembled bytes are the segment's own, so warm and cold
steps give bit-identical results.
:meth:`process` stays the serial entry: one pageable upload and the
chain.

Micro-batch (``micro_batch_segments`` = B > 1, the fused plans only, as
in the reference): one dispatch runs B segments.  The reference vmaps
its fused plan over a leading batch axis; here :meth:`stage_batch`
uploads each segment from its pinned buffer into its row of one device
``[B, bytes]`` tensor on the copy stream (or, warm, B strides behind the
carry into one window ``carry ++ new_0 ++ ... ++ new_{B-1}`` whose
overlapping views are the B segments), and :meth:`run_batch` runs the
chain once a lane, in lane order, so each lane launches the kernels a
single dispatch launches and gives its bits.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.kernels.fft2_front import (fft2_pass1_front,
                                                 fft2_pass2_spectrum,
                                                 front_mean_power)
from srtb_tpu_torch.kernels.dedisperse import dedisperse
from srtb_tpu_torch.kernels.rfi_chirp import (rfi_s1_dedisperse,
                                                rfi_threshold)
from srtb_tpu_torch.kernels.sk import sk_apply_timeseries, sk_zap_timeseries
from srtb_tpu_torch.kernels.unpack import (unpack_subbyte_planes_window,
                                             unpack_subbyte_window)
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import unpack as U
from srtb_tpu_torch.ops import window as W
from srtb_tpu_torch.pipeline import registry
from srtb_tpu_torch.quality import stats as Q
from srtb_tpu_torch.utils.device import resolve_device
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


def unpack_streams(raw: torch.Tensor, variant: str, nbits: int,
                   window: torch.Tensor | None) -> torch.Tensor:
    """The unpack of ``variant``, its data streams stacked into float32
    [S, n] (the reference's dispatch, ref: unpack_pipe.hpp:46-136,
    392-413)."""
    if variant == "simple":
        return U.unpack(raw, nbits, window)[None, :]
    if variant == "interleaved_samples_2":
        return torch.stack(U.unpack_interleaved_2pol(raw, nbits, window))
    if variant == "naocpsr_snap1":
        return torch.stack(U.unpack_naocpsr_snap1(raw, nbits, window))
    if variant == "gznupsr_a1":
        return torch.stack(U.unpack_gznupsr_a1(raw, window))
    if variant == "gznupsr_a1_v2_1":
        return torch.stack(U.unpack_gznupsr_a1_v2_1(raw, window))
    raise ValueError(f"unknown unpack variant {variant!r}")


# the unpack variants whose streams K1 unpacks at 1/2/4 bits: "simple"
# as it is, the byte-interleaved ones after the bytes' de-interleave
K1_VARIANTS = ("simple", "interleaved_samples_2", "naocpsr_snap1")


# Segments of at least this many samples take the reference's staged plan.
STAGED_MIN_N = 1 << 30

# Largest n/2 at which fused_tail = "auto" fuses the bankless plans
# (staged, or use_pallas) in the reference.
FUSED_TAIL_DF64_MAX_SPECTRUM = 1 << 27

# the reference's refusal of a micro-batch on the staged plan
BATCH_NEEDS_FUSED = ("micro_batch_segments > 1 requires the fused plan "
                     "(staged segments are already dispatch-amortized)")

STRATEGIES = ("auto", "monolithic", "four_step", "mxu", "pallas", "pallas2")


def staged_resolves(cfg: Config, staged: bool | None = None) -> bool:
    """The reference's staged-plan flag: explicit, or n >= 2^30."""
    if staged is not None:
        return staged
    return int(cfg.baseband_input_count or 0) >= STAGED_MIN_N


def fused_tail_resolves(cfg: Config, staged: bool) -> bool:
    """The reference's resolution of ``fused_tail`` (auto/on/off): the
    staged plan and every non-monolithic strategy end in the Hermitian
    post-process, which hosts the stage-1 + chirp epilogue; "auto" leaves
    the bankless plans (staged, use_pallas) unfused above n/2 = 2^27.
    Raises on "on" with the monolithic R2C."""
    mode = str(cfg.fused_tail).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_tail must be auto/on/off, got {mode!r}")
    if mode == "off":
        return False
    n = int(cfg.baseband_input_count)
    hostable = staged or F.resolve_strategy(
        n, cfg.fft_strategy) != "monolithic"
    if mode == "on":
        if not hostable:
            raise ValueError(
                "fused_tail=on requires a non-monolithic fft_strategy (the "
                "monolithic R2C cannot host the RFI/chirp epilogue)")
        return True
    if not hostable:
        return False
    bankless = staged or cfg.use_pallas
    return not (bankless and n // 2 > FUSED_TAIL_DF64_MAX_SPECTRUM)


# the staged row implementations the reference names; the "_interpret"
# spellings (Pallas's interpret mode) are the same kernels here
ROWS_IMPLS = ("xla", "four_step", "mxu", "monolithic", "auto", "pallas",
              "pallas_interpret", "pallas2", "pallas2_interpret")


# the environment switches the port's plan reads (:func:`staged_env`),
# which enter :meth:`SegmentProcessor.plan_signature` too
STAGED_ENV_KNOBS = ("SRTB_STAGED_ROWS_IMPL", "SRTB_STAGED_BLOCKED",
                    "SRTB_PALLAS_FFUSE")


def staged_env() -> tuple[str, bool, bool]:
    """The reference's three environment switches of the staged plan, read
    here and nowhere else (:data:`STAGED_ENV_KNOBS`):
    ``SRTB_STAGED_ROWS_IMPL`` (who runs the staged R2C's C2C, "xla" by
    default), ``SRTB_STAGED_BLOCKED`` (the blocked-plane staged pack) and
    ``SRTB_PALLAS_FFUSE`` (=1: front_fuse = "auto" may resolve on).  Both
    packages resolve the same plan from the same environment."""
    rows, blocked, ffuse = STAGED_ENV_KNOBS
    return (os.environ.get(rows, "xla"),
            bool(int(os.environ.get(blocked, "0"))),
            os.environ.get(ffuse, "") == "1")


def resolve_rows_impl(impl: str) -> str:
    """A staged row implementation's name with the ``_interpret`` suffix
    dropped; unknown names raise, as in the reference."""
    if impl not in ROWS_IMPLS:
        raise ValueError(f"unknown rows impl / fft strategy {impl!r}")
    return impl.removesuffix("_interpret")


def _front_fuse_structural(cfg: Config, staged: bool) -> bool:
    """Whether the front-fused staged plan (B11/B12) is structurally
    possible: the staged plan with pallas2 rows and not the blocked pack,
    an unpack variant and width B11 reads, a fused tail, and a length
    ``ffuse_factor`` splits (the reference's rule)."""
    if not staged:
        return False
    impl, blocked, _ = staged_env()
    if impl not in ("pallas2", "pallas2_interpret") or blocked:
        return False
    variant = formats.unpack_variant(cfg.baseband_format_type)
    if int(cfg.baseband_input_bits) not in K2.FFUSE_VARIANT_BITS.get(
            variant, ()):
        return False
    if not fused_tail_resolves(cfg, staged):
        return False
    return K2.ffuse_factor(int(cfg.baseband_input_count) // 2) is not None


def front_fuse_resolves(cfg: Config, staged: bool) -> bool:
    """The reference's resolution of ``front_fuse`` (auto/on/off): "on"
    raises ``ValueError`` when the fusion is structurally impossible;
    "auto" fuses only with ``SRTB_PALLAS_FFUSE=1`` (the reference's TPU
    compiler probe is false)."""
    mode = str(cfg.front_fuse).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"front_fuse must be auto/on/off, got {mode!r}")
    if mode == "off":
        return False
    ok = _front_fuse_structural(cfg, staged)
    if mode == "on":
        if not ok:
            raise ValueError(
                "front_fuse=on requires the staged plan with "
                "SRTB_STAGED_ROWS_IMPL=pallas2, a fusable tail "
                "(fused_tail != off, non-monolithic), a simple "
                "1/2/4/8-bit or 2-pol byte-interleaved format, and a "
                "pallas2-factorizable length")
        return True
    return ok and staged_env()[2]


def ring_usable(cfg: Config) -> bool:
    """Whether overlap-save reserves a non-empty, byte-aligned tail
    strictly smaller than the segment: the ingest ring's structural
    precondition, whatever ``ingest_ring`` says (the reference's rule)."""
    fmt = formats.resolve(cfg.baseband_format_type)
    bits = abs(int(cfg.baseband_input_bits))
    nres = int(dd.nsamps_reserved(cfg))
    reserved = nres * bits // 8 * fmt.data_stream_count
    seg = cfg.segment_bytes(fmt.data_stream_count)
    return nres > 0 and (nres * bits) % 8 == 0 and 0 < reserved < seg


def sk_tiling_ok(nfreq: int, ntime: int) -> bool:
    """The reference's gate of the SK kernel pair (K3/K4, and K4 after
    B7): rows in blocks of up to 8, time in blocks of up to 2^15 that are
    multiples of 128."""
    rows = min(8, nfreq)
    tb = min(256 * 128, ntime)
    return not (nfreq % rows or ntime % 128 or ntime % tb or tb % 128)


def hbm_passes(fused_tail: bool, skzap: bool, front_fuse: bool) -> int:
    """The plan's floor of spectrum-sized HBM sweeps (reads or writes) a
    segment, the reference's traffic model of its roofline gauges: the
    R2C's read and write (2), stage 1 and the chirp's (2, folded into
    the fused tail), the waterfall FFT's (2) and the SK and detection
    re-read (1, folded into the skzap kernel); a front-fused plan's
    floor is its two sweeps of the blocked intermediate (2).  Which
    kernels run a group changes the traffic only upward from this
    floor, so the gauges stay lower bounds."""
    if front_fuse:
        return 2
    return 2 + (0 if fused_tail else 2) + 2 + (0 if skzap else 1)


# the port's own entry in every plan signature
PLAN_SIGNATURE_PORT = "torch-v1"


def check_plan(cfg: Config) -> None:
    """Raise for settings no plan takes: an unregistered ``search_mode``
    (as ``registry.resolve_mode`` raises) or an unknown ``fft_strategy``."""
    registry.resolve_mode(cfg)
    if cfg.fft_strategy not in STRATEGIES:
        raise ValueError(f"unknown fft_strategy {cfg.fft_strategy!r}")


class SegmentProcessor:
    """Owns the per-segment constants (window, de-window, RFI keep mask,
    normalization coefficient, reserved-sample count) on ``device``,
    resolves the reference's plan, and runs the device chain on one
    segment at a time."""

    MODE = "single_pulse"

    # Config fields that shape the chain a plan runs (the reference's
    # ``_TRACE_CFG_KEYS``, the fields of its traced programs): an
    # allowlist, so that I/O, GUI and path settings never enter the
    # plan signature
    _TRACE_CFG_KEYS = (
        "baseband_input_count", "baseband_input_bits",
        "baseband_format_type", "baseband_freq_low",
        "baseband_bandwidth", "baseband_sample_rate", "dm", "dm_list",
        "spectrum_channel_count", "signal_detect_signal_noise_threshold",
        "signal_detect_max_boxcar_length", "signal_detect_channel_threshold",
        "mitigate_rfi_average_method_threshold",
        "mitigate_rfi_spectral_kurtosis_threshold",
        "mitigate_rfi_freq_list", "baseband_reserve_sample",
        "fft_strategy", "fft_len_cap", "use_pallas", "use_pallas_sk",
        "use_emulated_fp64", "fused_tail", "front_fuse", "chirp_exact",
        # the engine's settings that change what a dispatch runs: the
        # micro-batch and the window around it
        "inflight_segments", "micro_batch_segments",
        # the ring changes which step runs a segment
        "ingest_ring",
        # the quality epilogue and its constants
        "quality_stats", "quality_coarse_bins",
        "quality_dead_threshold", "quality_hot_threshold",
        "quality_subsample",
    )

    def __init__(self, cfg: Config, window_name: str = W.DEFAULT_WINDOW,
                 device=None, staged: bool | None = None):
        check_plan(cfg)
        self.cfg = cfg
        self._window_name = window_name
        self.device = resolve_device(device)
        self.fmt = formats.resolve(cfg.baseband_format_type)
        n = cfg.baseband_input_count
        if n & (n - 1):
            raise ValueError("baseband_input_count must be a power of 2")
        self.n = n
        self.n_spectrum = n // 2  # after R2C + drop-Nyquist
        self.channel_count = min(cfg.spectrum_channel_count, self.n_spectrum)
        self.watfft_len = self.n_spectrum // self.channel_count

        # ---- the plan, resolved as the reference resolves it ----
        self.staged = staged_resolves(cfg, staged)
        self.strategy = F.resolve_strategy(n, cfg.fft_strategy)
        self.fused_tail = fused_tail_resolves(cfg, self.staged)
        # the front-fused staged plan (B11/B12)
        self.front_fuse = front_fuse_resolves(cfg, self.staged)
        self.streams = self.fmt.data_stream_count
        # sub-byte segments of the simple format take the blocked-plane
        # R2C on the non-monolithic strategies, and on the staged plan
        # with SRTB_STAGED_BLOCKED=1 (the reference's rule)
        subbyte = (cfg.baseband_input_bits in (1, 2, 4)
                   and self.fmt.unpack_variant == "simple")
        self._blocked_subbyte = (
            not self.staged and subbyte
            and self.strategy in ("four_step", "mxu", "pallas", "pallas2"))
        self._staged_blocked = False
        if self.staged and not self.front_fuse:
            impl, blocked, _ = staged_env()
            self._staged_blocked = blocked and subbyte
            self._rows_impl = self._staged_impl(resolve_rows_impl(impl))
        # the whole waterfall tail in one kernel (B8)
        self._skzap = bool(
            self.fused_tail and cfg.use_pallas and cfg.use_pallas_sk
            and KF.supported(self.watfft_len, self.channel_count))
        self.hbm_passes = hbm_passes(self.fused_tail, self._skzap,
                                     self.front_fuse)
        self._len_cap = cfg.fft_len_cap or None

        win = W.window_coefficients(window_name, n)
        self.window = None if win is None else \
            torch.from_numpy(win).to(self.device)
        self.window_planes = None
        if (self._blocked_subbyte or self._staged_blocked) \
                and win is not None:
            self.window_planes = torch.from_numpy(F.subbyte_window_planes(
                win, cfg.baseband_input_bits)).to(self.device)
        # the window divided out of the waterfall after the backward C2C
        # (ref: fft_pipe.hpp:346-359), zero edges already sanitized to 1
        wat_win = W.dewindow_coefficients(window_name, self.watfft_len)
        self.watfft_dewindow = None if wat_win is None else \
            torch.from_numpy(wat_win).to(self.device)

        self.f_min, self.f_c, self.df = dd.spectrum_frequencies(
            cfg, self.n_spectrum)
        zap = rfi.rfi_ranges_to_mask(
            rfi.eval_rfi_ranges(cfg.mitigate_rfi_freq_list), self.n_spectrum,
            cfg.baseband_freq_low, cfg.baseband_bandwidth)
        # on the device once, in the form its one consumer takes: the
        # plain stage 1 of the staged plan without use_pallas or the fused
        # tail the zap mask, K2 on every other plan the KEEP mask (True =
        # keep), B12 the keep mask blocked
        self._plain_s1 = (self.staged and not cfg.use_pallas
                          and not self.fused_tail)
        self.rfi_zap = self.rfi_keep = None
        if zap is not None and self._plain_s1:
            self.rfi_zap = torch.from_numpy(zap).to(self.device)
        elif zap is not None:
            self.rfi_keep = torch.from_numpy(~zap).to(self.device)
        self.norm_coeff = rfi.normalization_coefficient(
            self.n_spectrum, self.channel_count)
        if self.front_fuse:
            self._init_front_fuse()
        self.nsamps_reserved = dd.nsamps_reserved(cfg)
        # trim of the waterfall time axis (ref: signal_detect_pipe.hpp:289-299)
        self.time_reserved_count = self.nsamps_reserved // self.channel_count
        self._segment_bytes = cfg.segment_bytes(self.fmt.data_stream_count)
        # the ingest ring: the reserved tail stays on the device as the
        # carry, and a warm step uploads only the stride's new bytes
        self.reserved_bytes = int(
            self.nsamps_reserved * abs(cfg.baseband_input_bits) // 8
            * self.fmt.data_stream_count)
        self.stride_bytes = self._segment_bytes - self.reserved_bytes
        self.ring = self._resolve_ring()
        # uploads by stage_input: bytes, and the ring's cold and warm steps
        # (the registry counts h2d_bytes and ring_cold_dispatches too)
        self.h2d_bytes = 0
        self.ring_cold_dispatches = 0
        self.ring_warm_dispatches = 0
        # the program families this processor has dispatched once (the
        # first dispatch of each is timed as its compile), and the
        # stream's labels for their counters
        self._dispatched_programs: set[str] = set()
        stream = str(cfg.stream_name or "")
        self._metric_labels = {"stream": stream} if stream else None
        self._copy_stream = None
        # the quality epilogue's (coarse bins, dead and hot thresholds,
        # subsample), as the reference reads them; None: off
        self.quality_params = None
        if cfg.quality_stats:
            self.quality_params = (int(cfg.quality_coarse_bins or 64),
                                   float(cfg.quality_dead_threshold),
                                   float(cfg.quality_hot_threshold),
                                   int(cfg.quality_subsample or 1))
        # the runtime sanitizer's boundary tripwires (``sanitize``): they
        # change when the host waits, never what the chain computes, so
        # they stay out of the plan signature
        self._sanitize = bool(cfg.sanitize)
        # the compiled-kernel cache (``aot_plan_path``): the kernel
        # library built or loaded now, so that the first segment does not
        # pay for the build
        self.aot_active = False
        if cfg.aot_plan_path:
            if not self.enable_aot(cfg.aot_plan_path):
                # the reference's text word for word; the port's cache
                # has no opt-in on the CPU
                log.warning(
                    "[segment] aot_plan_path set but the AOT cache is "
                    "inactive (CPU backend without SRTB_AOT_ALLOW_CPU=1)"
                    " — restarts will recompile")
        log.debug(f"[segment] n={n} spectrum={self.n_spectrum} "
                  f"channels={self.channel_count} watfft={self.watfft_len} "
                  f"reserved={self.nsamps_reserved} plan={self.plan_name} "
                  f"device={self.device}")

    def enable_aot(self, path: str) -> bool:
        """Build or load the kernel library through the compiled-kernel
        cache at ``path`` (``utils/aot_cache.py``, keyed by
        :meth:`plan_signature`) and make it the library every kernel
        launches from.  Returns False when the cache is off (on the CPU):
        nothing is built or written, and the kernels build at their first
        launch as before."""
        from srtb_tpu_torch.kernels import build
        from srtb_tpu_torch.utils.aot_cache import AotPlanCache
        cache = AotPlanCache(path, device=self.device,
                             labels=self._metric_labels)
        if not cache.enabled():
            return False
        lib = cache.get_or_build("kernels", self.plan_signature())
        if self.device.type == "cuda":
            build.install_library(lib)
        self.aot_active = True
        return True

    @property
    def plan_name(self) -> str:
        """The reference's plan id (``SegmentProcessor.plan_name``) for
        this configuration."""
        name = ("staged" if self.staged else "fused") + f":{self.strategy}"
        if self.fused_tail:
            name += "+ftail"
        if self.front_fuse:
            name += "+ffuse"
        if self._skzap:
            name += "+skzap"
        if self.ring:
            name += "+ring"
        return name

    @classmethod
    def _trace_projection(cls, cfg) -> tuple[dict, dict]:
        """The (config fields, environment switches) that shape the
        chain: :data:`_TRACE_CFG_KEYS` the config has, and the switches
        of :data:`STAGED_ENV_KNOBS` that are set.  Run-local variables
        (``SRTB_BENCH_*``, cache and log paths) stay out, so that a
        signature changes only with the plan."""
        cfg_d = {k: getattr(cfg, k) for k in cls._TRACE_CFG_KEYS
                 if hasattr(cfg, k)}
        knobs = {k: os.environ[k] for k in STAGED_ENV_KNOBS
                 if k in os.environ}
        return cfg_d, knobs

    def plan_signature(self) -> str:
        """Stable string naming everything that shapes the chain this
        processor runs: the trace-shaping config fields and environment
        switches, and the resolved plan flags (the reference's
        signature, with ``PLAN_SIGNATURE_PORT`` in place of its JAX-only
        ``interp`` and ``donate_input``, so that a signature of the
        reference and one of the port never compare equal)."""
        import json

        cfg_d, knobs = self._trace_projection(self.cfg)
        return json.dumps(
            {"cfg": cfg_d, "env": knobs, "mode": self.MODE,
             "port": PLAN_SIGNATURE_PORT,
             "staged": self.staged,
             "window": self._window_name,
             # the reference's chirp-bank rule: the plans whose chirp
             # it takes from a precomputed bank (the port's kernels make
             # the exact chirp on every plan)
             "has_chirp": not (self.staged or self.cfg.use_pallas),
             "fused_tail": self.fused_tail,
             "front_fuse": self.front_fuse,
             "skzap": self._skzap,
             "hbm_passes": self.hbm_passes,
             "ingest": "ring-v1" if self.ring else "direct",
             # the staged plan runs as one chain here: no boundary
             # tensors between its programs
             "boundary": "chain-v1"},
            sort_keys=True, default=str)

    def _resolve_ring(self) -> bool:
        """``ingest_ring`` ("auto"/"on"/"off") against the plan, as the
        reference resolves it: "auto" takes the ring whenever
        :func:`ring_usable`, "on" raises ``ValueError`` when it is not,
        "off" uploads every segment whole."""
        mode = str(self.cfg.ingest_ring).lower()
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"ingest_ring must be auto/on/off, got {mode!r}")
        if mode == "off":
            return False
        usable = ring_usable(self.cfg)
        if mode == "on" and not usable:
            raise ValueError(
                "ingest_ring=on requires overlap-save with a byte-"
                "aligned reserved tail (baseband_reserve_sample with "
                f"0 < reserved_bytes < segment_bytes; got reserved="
                f"{self.reserved_bytes} of {self._segment_bytes})")
        return usable

    def _staged_impl(self, impl: str) -> str:
        """The staged row implementation after the two-pass window check:
        pallas2 covers C2C lengths 2^24 ... 2^29 only, and smaller
        segments take the four-step on B6 legs (the reference's dispatch
        by size)."""
        if impl == "pallas2":
            count = (8 // self.cfg.baseband_input_bits
                     if self._staged_blocked else 2)
            if not K2.supported(self.n // count):
                return "pallas"
        return impl

    def _init_front_fuse(self) -> None:
        """The front-fused plan's constants: the factorization, the unpack
        variant, the window split into its even and odd samples viewed
        [n1, n2], the keep mask blocked (bin k = k2 n1 + k1 at [k1, k2];
        it replaces the natural-order one, which this plan never reads)
        and the chirp."""
        n1, n2 = self._ffuse_fac = K2.ffuse_factor(self.n_spectrum)
        self._ffuse_variant = formats.unpack_variant(self.fmt.name)
        self._ffuse_window = None
        if self.window is not None:
            self._ffuse_window = tuple(
                self.window[i::2].reshape(n1, n2).contiguous()
                for i in (0, 1))
        self._ffuse_keep = None
        if self.rfi_keep is not None:
            self._ffuse_keep = self.rfi_keep.reshape(n2, n1).T.contiguous()
            self.rfi_keep = None
        self._ffuse_chirp = (self.f_min, self.df, self.f_c, self.cfg.dm)

    def _as_device_bytes(self, raw) -> torch.Tensor:
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8))
        if raw.dtype != torch.uint8 or tuple(raw.shape) != (
                self._segment_bytes,):
            raise ValueError(f"segment must be uint8 [{self._segment_bytes}]"
                             f", got {raw.dtype} {tuple(raw.shape)}")
        return raw.to(self.device)

    def _unpack(self, raw: torch.Tensor) -> torch.Tensor:
        """raw bytes -> windowed float32 samples [S, n] in sample order: K1
        once a stream for 1/2/4 bits of the ``K1_VARIANTS`` (the bytes of
        an interleaved segment de-interleaved first), else
        :func:`unpack_streams`."""
        bits = self.cfg.baseband_input_bits
        variant = self.fmt.unpack_variant
        if bits not in (1, 2, 4) or variant not in K1_VARIANTS:
            return unpack_streams(raw, variant, bits, self.window)
        rows = raw[None] if variant == "simple" else \
            U.deinterleave_bytes(raw, variant)
        out = torch.empty(self.streams, self.n, dtype=torch.float32,
                          device=raw.device)
        for s in range(self.streams):
            unpack_subbyte_window(rows[s], bits, self.window, out=out[s])
        return out

    def _tail_epilogue(self):
        """The fused tail's epilogue on the assembled spectrum: the
        stage-1 threshold from Parseval over the packed C2C output, then
        K2 (zap, normalize, manual mask, exact chirp)."""
        cfg = self.cfg

        def epilogue(zf: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
            thr = (np.float32(cfg.mitigate_rfi_average_method_threshold)
                   * rfi.mean_power_packed(zf))
            return self._k2(spec, thr)
        return epilogue

    def _k2(self, spec: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
        """K2 once a stream on ``spec [S, m]``, stream s at ``thr[s]``
        (float32 [S, 1])."""
        out = torch.empty_like(spec)
        for s in range(spec.shape[0]):
            rfi_s1_dedisperse(spec[s], thr[s], self.norm_coeff, self.f_min,
                              self.df, self.f_c, self.cfg.dm,
                              keep=self.rfi_keep, out=out[s])
        return out

    def _spectrum(self, raw: torch.Tensor) -> torch.Tensor:
        """raw bytes -> the drop-Nyquist spectrum [S, n/2]; with the fused
        tail already zapped, normalized, masked and dedispersed."""
        if self.front_fuse:
            return self._front_spectrum(raw)
        epilogue = self._tail_epilogue() if self.fused_tail else None
        if self.staged:
            return self._staged_spectrum(raw, epilogue)
        if self._blocked_subbyte:
            z = unpack_subbyte_planes_window(raw, self.cfg.baseband_input_bits,
                                             self.window_planes)
            return F.rfft_subbyte(z[None], self.strategy,
                                  len_cap=self._len_cap, epilogue=epilogue)
        return F.segment_rfft(self._unpack(raw), self.strategy,
                              len_cap=self._len_cap, epilogue=epilogue)

    def _staged_c2c(self, z: torch.Tensor) -> torch.Tensor:
        """The staged plan's C2C of the packed sequence by the row
        implementation: one cuFFT call ("xla"), B9 + B10 + unblock
        ("pallas2" in its window), else the four-step on B6 legs (the
        reference runs its row kernel for every other name)."""
        if self._rows_impl == "xla":
            return F.fft_minor(z, inverse=False)
        if self._rows_impl == "pallas2":
            return K2.fft2_c2c(z)
        return F.four_step_fft(z, rows_impl="pallas", len_cap=self._len_cap)

    def _staged_spectrum(self, raw: torch.Tensor, epilogue):
        """The staged plan's R2C: K1 (or B13's planes with the blocked
        pack), then one cuFFT R2C, or the packed C2C and the Hermitian
        post that hosts the fused tail's epilogue."""
        bits = self.cfg.baseband_input_bits
        if self._staged_blocked:
            z = unpack_subbyte_planes_window(raw, bits, self.window_planes)
            return F.finish_rfft_subbyte(self._staged_c2c(z[None]),
                                         epilogue=epilogue)
        x = self._unpack(raw)
        if self._rows_impl == "xla" and epilogue is None:
            return F.rfft_drop_nyquist(x)
        return F.hermitian_rfft_post(self._staged_c2c(F.pack_even_odd(x)),
                                     drop_nyquist=True, epilogue=epilogue)

    def _front_spectrum(self, raw: torch.Tensor) -> torch.Tensor:
        """The front-fused plan: B11 on the raw bytes (every stream in one
        launch), each stream's stage-1 threshold from its Parseval sums,
        B12 once a stream, and the unblocking transpose to the
        natural-order dedispersed spectrum [S, n/2]."""
        n2 = self._ffuse_fac[1]
        b, aux = fft2_pass1_front(raw, self.n_spectrum, self._ffuse_variant,
                                  self.cfg.baseband_input_bits,
                                  self._ffuse_window)
        thr = np.float32(self.cfg.mitigate_rfi_average_method_threshold) \
            * front_mean_power(aux, n2, self.n_spectrum)
        blocked = torch.empty_like(b)
        for s in range(b.shape[0]):
            fft2_pass2_spectrum(b[s], thr[s:s + 1], self.norm_coeff,
                                keep=self._ffuse_keep,
                                chirp=self._ffuse_chirp, out=blocked[s])
        del b
        return K2.unblock(blocked)

    def _waterfall_detect(self, spec: torch.Tensor):
        """Waterfall backward C2C + SK zap + detection from the
        dedispersed spectrum [S, n/2], by the reference's branch rule:
        the row FFT of every stream in one launch (B6, B7), the kernels
        that take one stream (B8, K3, K4) once a stream."""
        cfg = self.cfg
        sk_thr = cfg.mitigate_rfi_spectral_kurtosis_threshold
        streams = spec.shape[0]
        f_len, t_len = self.channel_count, self.watfft_len
        t = det.trimmed_length(t_len, self.time_reserved_count)
        rows = F.waterfall_rows(spec, f_len)
        if self._skzap:
            tails = [KF.fft_rows_skzap(rows[s], sk_thr, inverse=True,
                                       dewindow=self.watfft_dewindow)
                     for s in range(streams)]
            wf = torch.stack([w for w, _z, _f, _t in tails])
            zero_count = torch.stack([
                torch.sum((zap | (fs0 == 0)).to(torch.int32),
                          dtype=torch.int32) for _w, zap, fs0, _t in tails])
            ts = torch.stack([ts for _w, _z, _f, ts in tails])
            del tails
        else:
            pallas_wf = cfg.use_pallas and KF.supported(t_len,
                                                        streams * f_len)
            pallas_sk = cfg.use_pallas_sk and sk_tiling_ok(f_len, t_len)
            if pallas_sk and pallas_wf:
                wf, s2, s4 = KF.fft_rows_stats(
                    rows, inverse=True, dewindow=self.watfft_dewindow)
                zap = rfi.sk_zap_decision(s2, s4, t_len, sk_thr)
                zero_count = torch.sum(
                    (zap | (rfi.power(wf[..., 0]) == 0)).to(torch.int32),
                    dim=-1, dtype=torch.int32)
                out = torch.empty_like(wf)
                ts = torch.stack([sk_apply_timeseries(wf[s], zap[s],
                                                      out=out[s])[1]
                                  for s in range(streams)])
                wf = out
            elif pallas_sk:
                wf = F.waterfall_c2c(spec, f_len, self.watfft_dewindow)
                out = torch.empty_like(wf)
                zero_counts, series = [], []
                for s in range(streams):
                    _, zc, ts_s = sk_zap_timeseries(wf[s], sk_thr, out=out[s])
                    zero_counts.append(zc)
                    series.append(ts_s)
                wf = out
                zero_count, ts = torch.stack(zero_counts), torch.stack(series)
            else:
                if pallas_wf:
                    wf = KF.fft_rows(rows, inverse=True)
                    if self.watfft_dewindow is not None:
                        wf = wf / self.watfft_dewindow
                else:
                    wf = F.waterfall_c2c(spec, f_len, self.watfft_dewindow)
                wf = rfi.mitigate_rfi_spectral_kurtosis(wf, sk_thr)
                return wf, det.detect(
                    wf, self.time_reserved_count,
                    cfg.signal_detect_signal_noise_threshold,
                    cfg.signal_detect_max_boxcar_length)
        result = det.detect_from_time_series(
            ts[:, :t], zero_count,
            cfg.signal_detect_signal_noise_threshold,
            cfg.signal_detect_max_boxcar_length)
        return wf, result

    # ---------------------------------------------------- retirement

    _retired = False

    def retire(self) -> None:
        """Disarm a processor the pipeline has replaced (a demotion, a
        promotion probe or a device reinit, ``resilience/demote.py``): a
        stray dispatch through it raises, and its device tables (window,
        masks, the front-fused constants) are dropped, so the allocator
        can hand their memory to the replacement."""
        self._retired = True
        for name, value in list(vars(self).items()):
            if isinstance(value, torch.Tensor) or (
                    isinstance(value, tuple) and value
                    and all(isinstance(v, torch.Tensor) for v in value)):
                setattr(self, name, None)

    def _check_live(self) -> None:
        if self._retired:
            raise RuntimeError(
                f"SegmentProcessor ({self.plan_name}) is retired: the "
                "pipeline replaced it (plan demotion, promotion or device "
                "reinit); a stray dispatch must not run on it")

    def process(self, raw) -> tuple[torch.Tensor, det.DetectResult]:
        """Run one segment, serially.  ``raw`` is the segment's uint8
        bytes (numpy or torch).  Returns ``(waterfall complex64 [S, F,
        T], DetectResult)`` with every result tensor on the processor's
        device."""
        return self.run_device(self._as_device_bytes(raw))

    # ------------------------------------------------------ H2D staging

    def stage_input(self, raw: np.ndarray,
                    carry: torch.Tensor | None = None) -> torch.Tensor:
        """Start the upload of one segment's bytes and return the whole
        segment on the device at once.  ``raw`` is contiguous uint8, and
        pinned on the card (the reader's buffers are).  On the card the
        copies run on the processor's copy stream and the caller's
        current stream (the compute stream) waits for them; the buffer
        is allocated on the copy stream and recorded on the compute
        stream, so the allocator reuses it only after the chain that
        reads it.  With ``carry`` (the ring's warm step: the previous
        segment's reserved tail, on the device) only
        ``raw[reserved_bytes:]`` is uploaded, behind a device copy of
        the carry into the buffer's head.  On the CPU both are plain
        copies."""
        self._check_live()
        src = self._upload_source(raw)
        if carry is not None:
            if not self.ring:
                raise ValueError("a carry requires the ingest ring "
                                 "(Config.ingest_ring)")
            src = src[self.reserved_bytes:]
            self.ring_warm_dispatches += 1
        elif self.ring:
            self._count_cold()
        self._count_h2d(src.nbytes)
        if self.device.type != "cuda":
            return src.clone() if carry is None else torch.cat([carry, src])
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(self._segment_bytes, dtype=torch.uint8,
                              device=self.device)
            if carry is not None:
                dev[:self.reserved_bytes].copy_(carry)
            dev[self._segment_bytes - src.numel():].copy_(
                src, non_blocking=True)
        compute.wait_stream(self._copy_stream)
        dev.record_stream(compute)
        return dev

    def _count_h2d(self, nbytes: int) -> None:
        self.h2d_bytes += nbytes
        metrics.add("h2d_bytes", nbytes)

    def _count_cold(self) -> None:
        """One full upload under the ring (the first segment, a break)."""
        self.ring_cold_dispatches += 1
        metrics.add("ring_cold_dispatches")

    def _upload_source(self, raw: np.ndarray) -> torch.Tensor:
        """One segment's host bytes as a tensor to upload from: contiguous
        uint8 of the segment's size, pinned on the card, else
        ``ValueError``."""
        if not (isinstance(raw, np.ndarray) and raw.dtype == np.uint8
                and raw.flags["C_CONTIGUOUS"]
                and raw.shape == (self._segment_bytes,)):
            raise ValueError(
                f"segment must be contiguous uint8 [{self._segment_bytes}]"
                f" bytes, got {type(raw).__name__} "
                f"{getattr(raw, 'dtype', None)} {np.shape(raw)}")
        src = torch.from_numpy(raw)
        if self.device.type == "cuda" and not src.is_pinned():
            raise ValueError("segment bytes must be pinned host memory "
                             "for an asynchronous upload")
        return src

    # -------------------------------------------------- device execution

    def _timed_first(self, name: str, fn):
        """``fn()``, the first dispatch of program family ``name`` on
        this processor timed as its compile: its host wall clock (the
        launches' enqueue and the kernels' builds at first use, not the
        card's execution) adds to ``compile_seconds`` and one to
        ``plan_compiles``, and sets ``last_compile_ms``, as the
        reference counts its first-dispatch trace and compile.  Marked
        only after ``fn`` returned: a failed first dispatch leaves the
        family to its retry."""
        if name in self._dispatched_programs or self.aot_active:
            # with the compiled-kernel cache the build happened (or was
            # loaded) at construction: no first-dispatch compile to count
            return fn()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        self._dispatched_programs.add(name)
        metrics.add("plan_compiles")
        metrics.add("compile_seconds", dt)
        metrics.set("last_compile_ms", dt * 1e3)
        if self._metric_labels is not None:
            metrics.add("plan_compiles", labels=self._metric_labels)
            metrics.add("compile_seconds", dt, labels=self._metric_labels)
        return out

    def run_device(self, raw: torch.Tensor
                   ) -> tuple[torch.Tensor, det.DetectResult]:
        """The chain on one segment's device-resident bytes, enqueued on
        the current stream: no host read, no synchronisation.  With
        ``quality_stats`` the result carries the quality vector."""
        return self._timed_first("staged" if self.staged else "fused",
                                 lambda: self._chain(raw))

    def _chain(self, raw: torch.Tensor
               ) -> tuple[torch.Tensor, det.DetectResult]:
        self._check_live()
        cfg = self.cfg
        spec = self._spectrum(raw)
        if self._sanitize:
            self._boundary("stage_a boundary", spec)
        if self._plain_s1:
            # the reference's staged stage (c) without use_pallas: XLA
            # stage 1 + manual mask, then its chirp kernel (B3 here), once
            # a stream
            spec = rfi.mitigate_rfi_manual(
                rfi.mitigate_rfi_average_and_normalize(
                    spec, cfg.mitigate_rfi_average_method_threshold,
                    self.norm_coeff), self.rfi_zap)
            # the reference's quality tap: the spectrum before the chirp
            q_spec = self._spectrum_quality(spec)
            out = torch.empty_like(spec)
            for s in range(spec.shape[0]):
                dedisperse(spec[s], self.f_min, self.df, self.f_c, cfg.dm,
                           out=out[s])
            spec = out
        else:
            if not self.fused_tail:
                # stage 1 + manual mask + chirp: K2 after a mean-power
                # reduction
                spec = self._k2(spec, rfi_threshold(
                    spec, cfg.mitigate_rfi_average_method_threshold))
            q_spec = self._spectrum_quality(spec)
        if self._sanitize:
            self._boundary("stage_b boundary", spec)
        wf, result = self._waterfall_detect(spec)
        if q_spec is not None:
            _bins, dead, hot, k = self.quality_params
            result = result._replace(quality=Q.pack_stats(
                q_spec, Q.waterfall_stats(wf, dead, hot, k)))
        return wf, result

    def _boundary(self, tag: str, spec: torch.Tensor) -> None:
        """The runtime sanitizer's tripwires at a chain boundary (the
        reference's staged stage ends: the spectrum after the R2C, and the
        dedispersed spectrum the waterfall is made from): the complex64
        [S, n/2] contract and no NaN/Inf.  Each waits for the card."""
        from srtb_tpu_torch.analysis import sanitizer as S
        S.check_contract(tag, spec, ndim=2, lead=self.streams,
                         dtype=torch.complex64)
        S.check_finite(tag, spec)

    def _spectrum_quality(self, spec: torch.Tensor):
        """The spectrum half of the quality vector (None when off),
        computed as soon as the spectrum the reference reads exists: after
        stage 1 and the manual mask (the chirp is unit-modulus, so before
        or after it the bins' powers agree to rounding and their zeros
        exactly), so that no spectrum is held for the epilogue; the
        waterfall half follows the SK zap (:meth:`run_device`)."""
        if self.quality_params is None:
            return None
        bins, _dead, _hot, k = self.quality_params
        return Q.spectrum_stats(spec, bins, k)

    def run_device_ring(self, raw: torch.Tensor, warm: bool = True):
        """The ring's step on a staged segment, warm or cold (the bytes
        are the segment's own either way, so are the results; ``warm``
        names the program family, ``ring`` or ``ring_cold``, staged
        ``staged_ring``/``staged_ring_cold``, as the reference's).
        Returns ``((waterfall, detect), next_carry)``: ``next_carry`` is
        the segment's reserved tail, a view of ``raw`` that the caller
        hands to the next warm ``stage_input``."""
        if not self.ring:
            raise ValueError("ingest ring disabled for this plan "
                             "(Config.ingest_ring / no reserved tail)")
        family = ("staged_" if self.staged else "") + (
            "ring" if warm else "ring_cold")
        return (self._timed_first(family, lambda: self._chain(raw)),
                raw[self.stride_bytes:])

    # ------------------------------------------------------ micro-batch

    def _check_batch(self, raw, width: int) -> None:
        """The reference's batch checks: the fused plan only, and a
        ``[B, width]`` array of bytes."""
        if self.staged:
            raise ValueError(BATCH_NEEDS_FUSED)
        if raw.ndim != 2 or raw.shape[1] != width:
            raise ValueError(
                f"batch must be [B, {width}] bytes, got {tuple(raw.shape)}")

    def _batch_on_device(self, raws, width: int) -> torch.Tensor:
        if isinstance(raws, np.ndarray):
            raws = torch.from_numpy(np.ascontiguousarray(raws,
                                                         dtype=np.uint8))
        self._check_batch(raws, width)
        return raws.to(self.device)

    def stage_batch(self, raws: list, carry: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """Start the uploads of B segments' bytes (each contiguous uint8,
        pinned on the card, as :meth:`stage_input` takes them) and return
        them on the device at once: cold, one ``[B, segment_bytes]``
        tensor, segment i in row i; warm (``carry``, the ring), the
        window ``carry ++ new_0 ++ ... ++ new_{B-1}`` of the B strides'
        new bytes behind the carry, flat, whose overlapping views are the
        B segments (:meth:`run_batch_ring`).  The copies run on the copy
        stream and the compute stream waits for them, as in
        :meth:`stage_input`; a batch counts one cold or warm ring
        dispatch."""
        self._check_live()
        if self.staged:
            raise ValueError(BATCH_NEEDS_FUSED)
        seg, res = self._segment_bytes, self.reserved_bytes
        srcs = [self._upload_source(raw) for raw in raws]
        if carry is not None:
            srcs = [src[res:] for src in srcs]
        if carry is not None:
            if not self.ring:
                raise ValueError("a carry requires the ingest ring "
                                 "(Config.ingest_ring)")
            self.ring_warm_dispatches += 1
        elif self.ring:
            self._count_cold()
        self._count_h2d(sum(s.nbytes for s in srcs))
        if self.device.type != "cuda":
            if carry is None:
                return torch.stack(srcs)
            return torch.cat([carry, *srcs])
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            if carry is None:
                dev = torch.empty(len(srcs), seg, dtype=torch.uint8,
                                  device=self.device)
                for row, src in zip(dev, srcs):
                    row.copy_(src, non_blocking=True)
            else:
                stride = self.stride_bytes
                dev = torch.empty(res + len(srcs) * stride,
                                  dtype=torch.uint8, device=self.device)
                dev[:res].copy_(carry)
                for i, src in enumerate(srcs):
                    dev[res + i * stride:res + (i + 1) * stride].copy_(
                        src, non_blocking=True)
        compute.wait_stream(self._copy_stream)
        dev.record_stream(compute)
        return dev

    def run_batch(self, raws: torch.Tensor) -> list:
        """The chain on B device-resident segments ``raws [B, bytes]``, a
        lane at a time in lane order, enqueued on the current stream: a
        list of B ``(waterfall, detect)``, each lane's bits a single
        dispatch's."""
        return self._timed_first("batch", lambda: self._lanes(raws))

    def _lanes(self, raws) -> list:
        return [self._chain(raw) for raw in raws]

    def run_batch_cold(self, raws: torch.Tensor):
        """The ring's cold batch step: :meth:`run_batch` and the next
        carry, the last segment's reserved tail (a view of ``raws``)."""
        if not self.ring:
            raise ValueError("ingest ring disabled for this plan "
                             "(Config.ingest_ring / no reserved tail)")
        return (self._timed_first("batch_cold", lambda: self._lanes(raws)),
                raws[-1, self.stride_bytes:])

    def run_batch_ring(self, window: torch.Tensor):
        """The ring's warm batch step on a window from
        :meth:`stage_batch`: segment i is ``window[i * stride :][:bytes]``
        (views, no copy); the next carry is the window's last
        ``reserved_bytes``."""
        if not self.ring:
            raise ValueError("ingest ring disabled for this plan "
                             "(Config.ingest_ring / no reserved tail)")
        seg, stride = self._segment_bytes, self.stride_bytes
        b = (window.numel() - self.reserved_bytes) // stride
        lanes = self._timed_first("batch_ring", lambda: self._lanes(
            [window[i * stride:i * stride + seg] for i in range(b)]))
        return lanes, window[window.numel() - self.reserved_bytes:]

    def process_batch(self, raws) -> list:
        """Micro-batch: B segments ``raws [B, bytes]`` (numpy or torch)
        in one dispatch; a list of B ``(waterfall, detect)`` on the
        processor's device."""
        return self.run_batch(self._batch_on_device(raws,
                                                    self._segment_bytes))

    def process_batch_ring(self, carry: torch.Tensor, news):
        """Micro-batch warm ring step: the device ``carry`` plus B stride
        uploads ``news [B, stride_bytes]`` run B overlapped segments.
        Returns ``(lanes, next_carry)``."""
        if not self.ring:
            raise ValueError("ingest ring disabled for this plan "
                             "(Config.ingest_ring / no reserved tail)")
        news = self._batch_on_device(news, self.stride_bytes)
        return self.run_batch_ring(torch.cat([carry, news.reshape(-1)]))

    def process_batch_cold(self, raws):
        """Micro-batch cold ring step: B whole segments, the lanes and
        the re-armed carry; counts one cold dispatch a batch."""
        if not self.ring:
            raise ValueError("ingest ring disabled for this plan "
                             "(Config.ingest_ring / no reserved tail)")
        self._count_cold()
        return self.run_batch_cold(self._batch_on_device(
            raws, self._segment_bytes))

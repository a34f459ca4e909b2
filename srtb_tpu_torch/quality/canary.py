"""End-to-end pulse-injection canary (port of
``srtb_tpu/quality/canary.py``).

Quality statistics (stats.py) say the *data* looks healthy; only a known
signal proves the *search* still finds signals.  Every
``Config.canary_every_segments``-th segment, a deterministic synthetic
dispersed pulse of known DM / amplitude / t0 is added to the segment's raw
uint8 bytes — upstream of unpack, FFT, RFI mitigation, dedispersion and
detection, so the recovered S/N exercises the whole science chain.  At
drain the recovered S/N is checked against the expected value; the
sensitivity ratio drives the ``detection_health_state`` gauge, the
/healthz detection section, the SLO sensitivity objective, and (on a
regression) an incident bundle with the recent quality timeline attached.

The delta is the reference's, bit for bit: a width-``canary_width`` burst
from ``PULSE_SEED``, dispersed through ``rfft``, the conjugate of the
complex64 chirp of ``ops/dedisperse.chirp_factor_host`` (same operations
in the same order), ``irfft``, rounded half to even to int16 and zeroed
over the head and tail ``reserved`` samples.  The port builds it on the
run's device in float64 with ``torch.fft`` (the chirp applied in blocks,
in place on the spectrum) and keeps it there as int16; the pipeline adds
it to the segment's bytes on the device, after the upload
(:meth:`CanaryController.inject_`), where the reference adds it to a host
copy.

Injection is quarantined by construction:

- the pulse is added to the STAGED bytes on the device; the pristine host
  buffer is what every sink sees, so ``baseband_write_all`` output is
  bit-identical to a canary-off run;
- the delta is zero over the first and last ``reserved`` samples of the
  segment: the head is the overlap region (the device-resident carry with
  the ingest ring), the tail becomes the NEXT segment's head/carry — a
  canary never leaks one byte into a neighboring science segment;
- canary segments are excluded from the ``signals`` gate and the science
  sinks by the engine (pipeline/runtime.py), and flagged in the journal
  span + run manifest so offline consumers can prove the quarantine.

Expected S/N is **auto-calibrated** by default (``canary_expected_snr =
0``): the first checked canary of a run sets the reference (journaled as
``calibrated``), and later canaries must recover at least
``canary_min_ratio`` of it.
"""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.ops.dedisperse import D
from srtb_tpu_torch.utils import slo
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# deterministic pulse-shape seed: the SAME broadband noise burst in every
# run, every resume, every process — canary recovery must be
# bit-identical across checkpoint resume
PULSE_SEED = 1644

HEALTH_OK = 0
HEALTH_DEGRADED = 1

# elements a step of the blocked chirp multiply, rounding and injection:
# bounds each step's temporaries at 2^30 samples
BLOCK = 1 << 24


def chirp_factor_block(m: int, i0: int, f_min: float, df: float,
                       f_c: float, dm: float, device) -> torch.Tensor:
    """complex64 chirp factors of channels ``i0 .. i0 + m - 1``: the
    operations of ``ops/dedisperse.chirp_factor_host`` in its order, in
    float64, rounded to complex64 at the end.  Every divisor is a tensor
    on the device, so that each quotient is a true division (torch's CUDA
    division by a host scalar multiplies by its reciprocal)."""
    f64 = torch.float64
    i = torch.arange(i0, i0 + m, dtype=torch.int64, device=device).to(f64)
    f = f_min + df * i
    delta_f = f - f_c
    fc = torch.tensor(f_c, dtype=f64, device=device)
    q = delta_f / fc
    k = torch.tensor((D * 1e6) * dm, dtype=f64, device=device) / f * (q * q)
    delta_phi = (-2.0 * np.pi) * (k - torch.trunc(k))
    return torch.complex(torch.cos(delta_phi).to(torch.float32),
                         torch.sin(delta_phi).to(torch.float32))


class CanaryController:
    """Deterministic injection schedule + sensitivity gate.  ``None``
    (from_config) when ``canary_every_segments`` is 0.  ``device`` is
    where the delta is built and kept (the run's device)."""

    def __init__(self, cfg, n_samples: int, reserved_samples: int = 0,
                 stream: str = "", device=None):
        self.every = int(cfg.canary_every_segments)
        self.amp = float(cfg.canary_amp)
        self.width = int(cfg.canary_width)
        dm = float(cfg.canary_dm)
        self.dm = dm if dm >= 0 else float(cfg.dm)
        self.position = float(cfg.canary_position)
        self.expected = float(cfg.canary_expected_snr)
        self.min_ratio = float(cfg.canary_min_ratio)
        self.calibrated = self.expected > 0
        self.n = int(n_samples)
        self.reserved = int(reserved_samples)
        self.stream = str(stream or "")
        self.device = torch.device(device if device is not None else "cpu")
        self._f_min = float(cfg.baseband_freq_low)
        self._bw = float(cfg.baseband_bandwidth)
        self._delta: torch.Tensor | None = None
        self.t0 = 0
        metrics.set("detection_health_state", HEALTH_OK)
        if self.stream:
            metrics.set("detection_health_state", HEALTH_OK,
                        labels={"stream": self.stream})

    @classmethod
    def from_config(cls, cfg, n_samples: int | None = None,
                    reserved_samples: int = 0,
                    device=None) -> "CanaryController | None":
        if int(cfg.canary_every_segments or 0) <= 0:
            return None
        # injection edits raw bytes, so it must know the byte<->sample
        # map: gated to the 8-bit single-stream "simple" layout; other
        # formats get a loud skip, never a silently wrong pulse
        if (cfg.baseband_input_bits != 8
                or cfg.baseband_format_type not in ("", "simple")):
            log.warning(
                "[canary] injection supports 8-bit 'simple' baseband "
                f"only (got {cfg.baseband_input_bits}-bit "
                f"{cfg.baseband_format_type!r}); canary disabled")
            return None
        return cls(cfg,
                   n_samples=int(n_samples
                                 if n_samples is not None
                                 else cfg.baseband_input_count),
                   reserved_samples=int(reserved_samples),
                   stream=str(cfg.stream_name or ""), device=device)

    # ---------------------------------------------------- injection

    def is_canary(self, abs_index: int) -> bool:
        """Absolute (resume-continuous) segment index -> scheduled?  The
        first canary lands on segment ``every - 1``, never on the cold
        first segment."""
        return (int(abs_index) + 1) % self.every == 0

    def dispersed_pulse(self) -> torch.Tensor:
        """The canary's float64 signal on ``self.device``, before rounding:
        a width-``canary_width`` broadband noise burst of per-sample
        amplitude ``canary_amp`` digitizer counts at t0 (sets ``t0``),
        dispersed by the inverse of the dedispersion chirp.  The
        spectrum's DC and Nyquist bins lose their imaginary parts before
        the inverse transform, as numpy's ``irfft`` discards them."""
        n, dev = self.n, self.device
        rng = np.random.default_rng(PULSE_SEED)
        usable = max(n - 2 * self.reserved - self.width, 1)
        self.t0 = self.reserved + int(self.position * usable)
        w = min(self.width, n - self.t0)
        burst = self.amp * rng.standard_normal(w)
        pulse = torch.zeros(n, dtype=torch.float64, device=dev)
        pulse[self.t0:self.t0 + w] = torch.from_numpy(burst).to(dev)
        spec = torch.fft.rfft(pulse)
        del pulse
        n_spec = n // 2
        df = self._bw / n_spec
        f_c = self._f_min + self._bw
        for i0 in range(0, n_spec, BLOCK):
            m = min(BLOCK, n_spec - i0)
            # disperse (medium model): spec * conj(complex64 chirp), the
            # product in complex128
            spec[i0:i0 + m] *= chirp_factor_block(
                m, i0, self._f_min, df, f_c, self.dm, dev).conj()
        spec[0].imag.zero_()
        spec[-1].imag.zero_()
        return torch.fft.irfft(spec, n)

    def _build_delta(self) -> torch.Tensor:
        """The additive int16 byte-delta of ONE canary injection, on
        ``self.device``: :meth:`dispersed_pulse` rounded half to even to
        counts, zeroed over the head and tail ``reserved`` spans."""
        sig = self.dispersed_pulse()
        n = self.n
        delta = torch.empty(n, dtype=torch.int16, device=self.device)
        for a in range(0, n, BLOCK):
            delta[a:a + BLOCK] = torch.round(sig[a:a + BLOCK])
        del sig
        if self.reserved:
            delta[:self.reserved] = 0
            delta[n - self.reserved:] = 0
        return delta

    def ensure_delta(self) -> torch.Tensor:
        """The delta, built on first use."""
        if self._delta is None:
            self._delta = self._build_delta()
        return self._delta

    def schedule(self, abs_index: int, size: int) -> dict | None:
        """The injection mark of segment ``abs_index`` of ``size`` bytes
        when it is scheduled, else None; counts ``canary_injected``.  A
        partial segment (file end) has another byte<->time map than the
        delta: skipped, loudly."""
        if not self.is_canary(abs_index):
            return None
        if int(size) != self.n:
            log.warning(f"[canary] segment {abs_index}: "
                        f"unexpected size {size} != {self.n}; "
                        "skipping injection")
            return None
        self.ensure_delta()
        metrics.add("canary_injected")
        if self.stream:
            metrics.add("canary_injected", labels={"stream": self.stream})
        return {"segment": int(abs_index), "t0": int(self.t0),
                "dm": self.dm, "amp": self.amp, "width": self.width}

    def inject_(self, raw: torch.Tensor) -> torch.Tensor:
        """Add the delta to one segment's uint8 bytes ``raw`` (on the
        delta's device) in place, clipped to [0, 255]: ``clip(int16(raw) +
        delta, 0, 255)``.  Only ``[reserved, n - reserved)`` is touched
        (the delta is zero elsewhere), so an overlap head that is the
        ring's carry, and a tail that becomes the next carry, stay as
        uploaded.  Enqueued on the current stream: no host read."""
        d = self.ensure_delta()
        for a in range(self.reserved, self.n - self.reserved, BLOCK):
            b = min(a + BLOCK, self.n - self.reserved)
            v = raw[a:b]
            v.copy_((v.to(torch.int16) + d[a:b]).clamp_(0, 255))
        return raw

    def prepare(self, abs_index: int, data) -> tuple:
        """The reference's dispatch-side hook on host bytes: returns
        ``(bytes, mark)``.  Non-canary segments pass ``data`` through
        untouched (no copy); a canary segment gets the pulse added to a
        COPY (numpy in, numpy out).  The pipeline does the same on the
        device with :meth:`schedule` and :meth:`inject_`."""
        mark = self.schedule(abs_index, len(data))
        if mark is None:
            return data, None
        raw = torch.as_tensor(np.asarray(data)).to(self.device, copy=True)
        return self.inject_(raw).cpu().numpy(), mark

    # --------------------------------------------------------- check

    def check(self, abs_index: int, snr_peaks) -> dict:
        """Drain-side hook for a canary segment: recovered S/N (max over
        boxcars, host values) against the expected reference.  Returns
        the verdict dict the span journals; updates the canary gauges,
        the detection-health state and the SLO sensitivity objective."""
        recovered = float(np.max(np.asarray(snr_peaks)))
        verdict = {"injected": True, "segment": int(abs_index),
                   "snr": round(recovered, 3)}
        if not self.calibrated:
            # the first checked canary of the run sets the reference —
            # journaled, so the baseline later ratios are judged against
            # is on the record
            self.expected = max(recovered, 1e-9)
            self.calibrated = True
            verdict.update(calibrated=True, expected=round(
                self.expected, 3), ratio=1.0, ok=True)
            ratio, ok = 1.0, True
        else:
            ratio = recovered / self.expected
            ok = ratio >= self.min_ratio
            verdict.update(expected=round(self.expected, 3),
                           ratio=round(ratio, 4), ok=ok)
        state = HEALTH_OK if ok else HEALTH_DEGRADED
        labels = [None] + ([{"stream": self.stream}] if self.stream
                           else [])
        for lbl in labels:
            metrics.add("canary_checked", labels=lbl)
            metrics.set("canary_last_snr", recovered, labels=lbl)
            metrics.set("canary_expected_snr", self.expected, labels=lbl)
            metrics.set("canary_sensitivity_ratio", ratio, labels=lbl)
            metrics.set("detection_health_state", state, labels=lbl)
            if not ok:
                metrics.add("canary_failed", labels=lbl)
        slo.note_canary(self.stream, ok)
        if not ok:
            log.warning(
                f"[canary] segment {abs_index}: sensitivity regression "
                f"— recovered S/N {recovered:.2f} is "
                f"{ratio:.2f}x the expected {self.expected:.2f} "
                f"(min ratio {self.min_ratio:g})")
        return verdict

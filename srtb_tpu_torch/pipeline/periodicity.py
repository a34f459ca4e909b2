"""The periodicity search mode (port of ``srtb_tpu/pipeline/periodicity.py``).

:class:`PeriodicitySegmentProcessor` extends the single-pulse
:class:`~srtb_tpu_torch.pipeline.segment.SegmentProcessor`: after the
device chain has made the dedispersed detection time series, the same
dispatch runs the harmonic-summed power-spectrum search and folds the
top-K candidates (``ops/periodicity.py``).  Every plan (fused, staged,
front-fused, the ring, micro-batch) ends in ``_waterfall_detect``, the
one method the class overrides, so each carries the mode.

The result type is a superset of ``DetectResult``: the single-pulse
fields first, under the same names, then the candidates.  Every
single-pulse consumer (``has_signal``, the writers) keeps working, and
three hooks on the result carry the mode's own rules into that shared
code: ``positive_gate`` (the engine's verdict), ``extra_artifacts``
(the candidate writer's ``.fold.npy`` and ``.cand.json``) and
``span_extra`` (the candidate table the span journal writes into each
segment's record).  The mode is registered in
``pipeline/registry.py``.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.io.writers import to_host
from srtb_tpu_torch.ops import periodicity as P
from srtb_tpu_torch.pipeline.segment import SegmentProcessor


class PeriodicityResult(NamedTuple):
    """``DetectResult`` superset: the single-pulse fields first (same
    names, same shapes), then the periodicity candidates, all batched
    over data streams."""

    # ---- single-pulse fields (ops/detect.DetectResult) ----
    zero_count: torch.Tensor
    time_series: torch.Tensor
    boxcar_lengths: tuple
    signal_counts: torch.Tensor
    boxcar_series: torch.Tensor
    snr_peaks: torch.Tensor
    # ---- periodicity fields (ops/periodicity.py), per stream ----
    candidate_bins: torch.Tensor        # [S, K] int32
    candidate_snr: torch.Tensor         # [S, K] f32 (harmonic-summed)
    candidate_harmonics: torch.Tensor   # [S, K] int32
    folded_profiles: torch.Tensor       # [S, K, n_bins] f32
    # static: (searched bins, harmonic levels), the trial count the
    # positive gate corrects for (the maximum of ~exponential per-bin
    # scores over M*L trials sits near ln(M*L), not near 0)
    candidate_trials: tuple = (1, 1)
    # the quality vector (DetectResult.quality), kept last
    quality: torch.Tensor | None = None

    # ---- the mode's hooks, read by mode-blind shared code on host
    # data after the fetch

    def _host2d(self, x) -> np.ndarray:
        a = to_host(x)
        return a.reshape(1, -1) if a.ndim < 2 else a

    def positive_gate(self, cfg) -> np.ndarray:
        """Per-stream positive verdict, trials-corrected:
        ``periodicity_snr_threshold`` is the margin above the noise
        maximum's expectation ln(trials)."""
        snr = self._host2d(self.candidate_snr)
        thr = float(cfg.periodicity_snr_threshold)
        m, levels = (int(np.asarray(t).reshape(-1)[0])
                     for t in self.candidate_trials)
        return (snr >= thr + float(np.log(max(m * levels, 2)))) \
            .any(axis=-1)

    def span_extra(self) -> dict:
        """The journal's payload: the candidate table of every segment,
        positive or not."""
        snr = self._host2d(self.candidate_snr)
        return {"periodicity": {
            "bins": self._host2d(self.candidate_bins).tolist(),
            "snr": [[round(float(x), 3) for x in row] for row in snr],
            "harmonics": self._host2d(self.candidate_harmonics).tolist()}}

    def extra_artifacts(self, base: str) -> list:
        """``(path, array)`` pairs the candidate writer persists for a
        positive segment through its temp + rename (+ manifest)
        transaction: per stream the folded profiles
        ``<base>[.sN].fold.npy`` ([K, n_bins] f32) and the candidate table
        ``<base>[.sN].cand.json`` (uint8 bytes).  Deterministic bytes:
        the same computation, rounding and key order."""
        prof = to_host(self.folded_profiles).astype(np.float32)
        if prof.ndim == 2:
            prof = prof[None]
        bins = self._host2d(self.candidate_bins)
        snr = self._host2d(to_host(self.candidate_snr).astype(np.float32))
        harm = self._host2d(self.candidate_harmonics)
        multi = prof.shape[0] > 1
        out = []
        for s in range(prof.shape[0]):
            stem = f"{base}.s{s}" if multi else base
            out.append((f"{stem}.fold.npy", prof[s]))
            meta = {"bins": [int(b) for b in bins[s]],
                    "snr": [round(float(x), 4) for x in snr[s]],
                    "harmonics": [int(h) for h in harm[s]]}
            payload = json.dumps(meta, sort_keys=True).encode() + b"\n"
            out.append((f"{stem}.cand.json",
                        np.frombuffer(payload, np.uint8)))
        return out


class PeriodicitySegmentProcessor(SegmentProcessor):
    """The single-pulse plan plus the periodicity search on its detection
    time series (module docstring)."""

    MODE = "periodicity"

    @property
    def plan_name(self) -> str:
        return super().plan_name + "+period"

    def _waterfall_detect(self, spec: torch.Tensor):
        """Every plan funnels through here: the single-pulse tail, then
        the periodicity module on its time series, one search a stream
        (the streams on the leading axis of one call)."""
        wf, det = super()._waterfall_detect(spec)
        cfg = self.cfg
        harmonics = int(cfg.periodicity_harmonics or 1)
        top_k = max(1, int(cfg.periodicity_candidates or 1))
        n_bins = max(2, int(cfg.periodicity_fold_bins or 2))
        min_bin = max(1, int(cfg.periodicity_min_bin or 1))
        cands = P.periodicity_search(det.time_series, harmonics, top_k,
                                     n_bins, min_bin=min_bin)
        m = det.time_series.shape[-1] // 2 + 1
        levels = P.harmonic_levels(harmonics)
        return wf, PeriodicityResult(
            *det[:6],
            candidate_bins=cands.bins,
            candidate_snr=cands.snr,
            candidate_harmonics=cands.harmonics,
            folded_profiles=cands.profiles,
            candidate_trials=(max(m - min_bin, 1), len(levels)),
            quality=det.quality)

"""How ``correct`` is decided: what the timed path produced, against the
plain reference (``portbench/reference``) run afterwards on the same
bytes, each number beside its limit (``portbench/limits/<cell>.json``).

A reading is a dict of one segment's detection as a side produced it:
``zero`` (zapped channels), ``counts`` and ``snr`` (per boxcar, or per DM
trial), ``series`` (the mean-removed time series, where the path hands it
out) and ``positive`` (the gate's verdict).  The numbers, each the worst
over the segments compared:

- ``verdict_mismatch``: segments whose verdict differs (in a DM search,
  also a pulsed segment whose best trial differs), exact;
- ``snr_gap``: |snr - snr_ref| / max(|snr_ref|, 1);
- ``count_gap``: |count - count_ref|, less the reference's samples that
  lie within rounding (``COUNT_BAND``) of the threshold, over
  max(count_ref, 1);
- ``zero_gap``: |zapped channels - the reference's|, where the reference
  decided the channels within rounding (``SK_BAND``) of an SK bound the
  judged side's way (``reference/chain.py``);
- ``series_gap``: |series - series_ref|_2 / |series_ref|_2;
- ``dump_gap``: a dumped waterfall's |wf - wf_ref|_2 / |wf_ref|_2;
- ``dump_mismatch``: dumps missing for a positive segment, dumps of a
  negative one, and bytes of a dumped ``.bin`` that differ from the
  segment's, exact.
"""

from __future__ import annotations

import numpy as np

def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))
                        / np.maximum(np.abs(np.asarray(b, np.float64)), 1.0)))


def l2_rel(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    den = float(np.linalg.norm(b.astype(np.complex128 if np.iscomplexobj(b)
                                        else np.float64)))
    num = float(np.linalg.norm((a.astype(np.complex128)
                                - b.astype(np.complex128))
                               if np.iscomplexobj(a) or np.iscomplexobj(b)
                               else a.astype(np.float64) - b))
    return num / den if den > 0 else num


def reading_of_detection(det, geo) -> dict:
    """A reference :class:`~portbench.reference.chain.Detection` as a
    reading."""
    return {"zero": det.zero_count, "counts": det.signal_counts,
            "snr": det.snr_peaks, "series": det.time_series,
            "positive": det.positive(geo), "ambiguous": det.ambiguous}


def reading_of_trials(dets: list, geo) -> dict:
    """A DM search's segment as its record states it: per trial the peak
    S/N over the boxcars, the counts summed, the zapped channels."""
    return {"zero": [d.zero_count for d in dets],
            "counts": [int(d.signal_counts.sum()) for d in dets],
            "snr": [float(d.snr_peaks.max()) for d in dets],
            "positive": any(d.positive(geo) for d in dets),
            "best": int(np.argmax([d.snr_peaks.max() for d in dets])),
            "ambiguous": [int(d.ambiguous.sum()) for d in dets]}


def compare(got: dict, ref: dict, numbers: dict, pulsed: bool) -> None:
    """Fold one segment's gaps into ``numbers`` (worst so far)."""
    bad = got["positive"] != ref["positive"]
    if pulsed and "best" in ref and got.get("best") != ref["best"]:
        bad = True
    numbers["verdict_mismatch"] += int(bad)
    numbers["snr_gap"] = max(numbers["snr_gap"], rel(got["snr"], ref["snr"]))
    counts = np.asarray(got["counts"], np.float64)
    want = np.asarray(ref["counts"], np.float64)
    slack = np.asarray(ref.get("ambiguous", 0), np.float64)
    excess = np.maximum(np.abs(counts - want) - slack, 0.0)
    numbers["count_gap"] = max(numbers["count_gap"], float(np.max(
        excess / np.maximum(want, 1.0))))
    numbers["zero_gap"] = max(numbers["zero_gap"], float(np.max(np.abs(
        np.asarray(got["zero"]) - np.asarray(ref["zero"])))))
    if "series" in got and "series" in ref:
        numbers["series_gap"] = max(numbers["series_gap"],
                                    l2_rel(got["series"], ref["series"]))


def fresh_numbers(keys) -> dict:
    return {k: 0 if k in ("verdict_mismatch", "dump_mismatch") else 0.0
            for k in keys}


def judge(numbers: dict, limits: dict, missing: int) -> tuple[bool, dict]:
    """``correct`` and the table {name: [value, limit]}: every number at
    or under its limit, and no compared segment without its answer."""
    table = {k: [numbers[k], limits[k]] for k in numbers}
    table["missing"] = [missing, 0]
    ok = missing == 0 and all(v <= lim for v, lim in table.values())
    return ok, table

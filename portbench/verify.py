"""After the window: the plain reference over a sample of the segments
the window finished, drawn from the seed, against what the engine
produced for them (``portbench/check.py`` has the numbers).

The sample holds every segment of the window that carries a pulse of its
own, up to ``check.pulsed`` more of those with a pool pulse, and
``check.noise`` of the rest.  Where the engine dumps candidates, every
positive segment of the window must have its ``.bin`` and ``.npy`` and no
negative one any; a sampled dump's bytes are compared with the segment's
and its waterfall with the reference's.

With ``control`` the reference in bfloat16 stands in the engine's place
for the sampled segments (what the limits were set against).
"""

from __future__ import annotations

import glob

import numpy as np
import torch

from portbench import check
from portbench.reference import chain


def _port_reading_dm(rec: dict, geo) -> dict:
    zero = np.asarray(rec["zero_counts"])
    counts = np.asarray(rec["signal_counts"])
    ok = zero < geo.channel_threshold * geo.channels
    return {"zero": zero, "counts": counts,
            "snr": np.asarray(rec["peak_snr"]),
            "positive": bool((ok & (counts > 0)).any()),
            "best": int(np.argmax(rec["peak_snr"]))}


def _sample(keys: list, bank, traffic: dict, rng) -> list:
    spec = traffic.get("check", {})
    own = [k for k in keys if k in bank.pulsed]
    pooled = [k for k in keys if k not in bank.pulsed and bank.is_pulsed(*k)]
    noise = [k for k in keys if not bank.is_pulsed(*k)]

    def pick(xs, n):
        if len(xs) <= n:
            return list(xs)
        idx = rng.choice(len(xs), size=n, replace=False)
        return [xs[i] for i in sorted(idx)]
    return sorted(own + pick(pooled, spec.get("pulsed", 4))
                  + pick(noise, spec.get("noise", 8)))


def _dump_files(prefix: str) -> dict:
    """{timestamp: (bin path, [npy paths])} of the dumps under ``prefix``."""
    out = {}
    for path in glob.glob(glob.escape(prefix) + "*.bin"):
        stem = path[len(prefix):-len(".bin")]
        if stem.isdigit():
            out[int(stem)] = (path, sorted(glob.glob(
                glob.escape(prefix + stem) + ".*.npy")))
    return out


def verify(cfg, traffic, bank, out, seed, limits, device,
           control: bool) -> dict:
    geo = chain.Geometry.from_cfg(cfg)
    dm_list = list(cfg.dm_list or [])
    readings = out["readings"]
    keys = sorted(k for k in out["in_window"] if k in readings)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    sample = _sample(keys, bank, traffic, rng)
    dumps = out.get("dumps", False)
    names = ["verdict_mismatch", "snr_gap", "count_gap", "zero_gap"]
    if not dm_list:
        names.append("series_gap")
    if dumps:
        names += ["dump_gap", "dump_mismatch"]
    numbers = check.fresh_numbers(names)
    files = {}
    if dumps:
        for stream, prefix in out["prefixes"].items():
            for ts, f in _dump_files(prefix).items():
                files[(stream, ts)] = f
        # every positive of the run has its dump, no negative one has
        for key, r in readings.items():
            has = (key[0], r["timestamp"]) in files
            if r["positive"] != has:
                numbers["dump_mismatch"] += 1
    missing = 0
    for key in sample:
        raw = torch.from_numpy(np.ascontiguousarray(
            bank.bytes_of(*key))).to(device)
        got = readings.get(key)
        if got is None:
            missing += 1
            continue
        # the reference decides the SK rows within rounding of a bound the
        # judged side's way (its zapped count says which way)
        if dm_list:
            if control:
                got = check.reading_of_trials(
                    chain.run_dm_trials(raw, geo, dm_list, "bfloat16"), geo)
            ref = check.reading_of_trials(
                chain.run_dm_trials(raw, geo, dm_list, "float64",
                                    zero_hints=got["zero"]), geo)
            check.compare(got, ref, numbers, bank.is_pulsed(*key))
            continue
        want_wf = dumps and got["positive"]
        wf_got = None
        if control:
            det_c, wf_got = chain.run_segment(raw, geo, "bfloat16", want_wf)
            got = dict(check.reading_of_detection(det_c, geo),
                       timestamp=got["timestamp"])
        det, wf_ref = chain.run_segment(raw, geo, "float64", want_wf,
                                        zero_hint=int(got["zero"]))
        ref = check.reading_of_detection(det, geo)
        check.compare(got, ref, numbers, bank.is_pulsed(*key))
        if want_wf:
            f = files.get((key[0], got["timestamp"]))
            if f is None or not f[1]:
                continue  # counted above as a missing dump
            if not control:
                on_disk = np.fromfile(f[0], dtype=np.uint8)
                seg = bank.bytes_of(*key)
                numbers["dump_mismatch"] += int(
                    on_disk.size != seg.size
                    or np.count_nonzero(on_disk != seg))
                wf_got = np.load(f[1][0])
            numbers["dump_gap"] = max(numbers["dump_gap"],
                                      check.l2_rel(wf_got, wf_ref))
        del raw
    lim = {k: limits.get(k, float("nan")) for k in names}
    ok, table = check.judge(numbers, lim, missing)
    # a run that compared nothing proved nothing
    ok = ok and bool(sample) and all(np.isfinite(v) for v in lim.values())
    return {"correct": bool(ok), "table": table,
            "sample": [list(k) for k in sample]}


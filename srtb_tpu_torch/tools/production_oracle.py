"""The float64 oracle at the production geometry (port of
``srtb_tpu/tools/production_oracle.py``).

The reference validates end to end on real recordings at its flagship
configuration (2^30-sample segments, 2^15 channels, |DM| 478.80, the
inverted 64 MHz band at 1405-1469 MHz).  This tool runs that chain once at
the given geometry — the port's chain on the card with the staged plan,
against the independent float64 transliteration of ``tools/oracle64.py``
over the same bytes — and records the largest errors, each beside its
gate, as a JSON artifact:

    python -m srtb_tpu_torch.tools.production_oracle [--log2n 30]
        [--log2chan 15] [--out artifacts/production_oracle_torch.json]
        [--device cpu]

The gates are the reference's: the waterfall within 1e-5 of its largest
magnitude, and the time series' two causes (the float32 summation order
and the waterfall's own error carried through |.|^2) each within
``ops/detect.time_series_error_gates``.  The oracle runs on the host in
float64 (about 60 GB of host memory at 2^30 / 2^15).  One JSON line to
stdout, the artifact to ``--out``; exit 0 when ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--log2n", type=int, default=30)
    p.add_argument("--log2chan", type=int, default=15)
    p.add_argument("--out", default="artifacts/production_oracle_torch.json")
    p.add_argument("--pulse_amp", type=float, default=30.0)
    p.add_argument("--device", default=None,
                   help="default: the card; cpu runs the plain versions")
    p.add_argument("--progress", action="store_true",
                   help="timestamped per-phase progress on stderr")
    args = p.parse_args(argv)
    t_start = time.monotonic()

    def mark(msg):
        if args.progress:
            print(f"[production_oracle +{time.monotonic() - t_start:.0f}s]"
                  f" {msg}", file=sys.stderr, flush=True)

    import numpy as np
    import torch

    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.io.synth import make_dispersed_baseband
    from srtb_tpu_torch.io.writers import to_host
    from srtb_tpu_torch.ops.detect import time_series_error_gates
    from srtb_tpu_torch.pipeline.segment import SegmentProcessor
    from srtb_tpu_torch.tools import oracle64 as ou
    from srtb_tpu_torch.utils.device import resolve_device
    from srtb_tpu_torch.utils.perf_ledger import device_name

    device = resolve_device(args.device)
    n = 1 << args.log2n
    # the J1644-4559 flagship parameters at the strict-parity thresholds
    # (1e9: no RFI threshold flips, so float32-against-float64 decision
    # jitter cannot mask numeric drift)
    cfg = Config(
        baseband_input_count=n,
        baseband_input_bits=2,
        baseband_format_type="simple",
        baseband_freq_low=1405.0 + 32.0,
        baseband_bandwidth=-64.0,
        baseband_sample_rate=128e6,
        dm=-478.80,
        spectrum_channel_count=1 << args.log2chan,
        signal_detect_signal_noise_threshold=6.0,
        signal_detect_max_boxcar_length=256,
        mitigate_rfi_average_method_threshold=1e9,
        mitigate_rfi_spectral_kurtosis_threshold=1e9,
        baseband_reserve_sample=False,
    )

    t0 = time.perf_counter()
    mark("synth start")
    # made on the run's device (a float64 host synthesis of 2^30 samples
    # takes minutes); the oracle reads the same bytes as the chain
    raw = make_dispersed_baseband(
        n, cfg.baseband_freq_low, cfg.baseband_bandwidth, cfg.dm,
        [n // 2], nbits=2, pulse_amp=args.pulse_amp, device=device,
        generator=torch.Generator(device=device).manual_seed(0)
    ).cpu().numpy()
    synth_s = time.perf_counter() - t0
    mark(f"synth done ({synth_s:.0f}s); the chain on {device}")

    # ---- the port's chain, the staged plan ----
    t0 = time.perf_counter()
    proc = SegmentProcessor(cfg, device=device, staged=True)
    wf, res = proc.process(raw)
    wf_dev = to_host(wf[0])            # stream 0: [F, T] complex64
    del wf
    ts_dev = to_host(res.time_series)[0]
    counts_dev = to_host(res.signal_counts)[0]
    plan = proc.plan_name
    del res, proc
    device_s = time.perf_counter() - t0
    mark(f"chain done ({device_s:.0f}s); the float64 oracle")

    # ---- the float64 oracle over the identical bytes ----
    t0 = time.perf_counter()
    x = ou.oracle_unpack(raw, cfg.baseband_input_bits)
    del raw
    wf_o, ts_o, nzap_o = ou.oracle_stream_chain(x, cfg)
    del x
    oracle_s = time.perf_counter() - t0
    mark(f"oracle done ({oracle_s:.0f}s); comparing")

    wf_scale = float(np.abs(wf_o).max())
    ts_scale = float(np.abs(ts_o).max())
    # the waterfall compared a block of rows at a time (a whole-array
    # difference is another complex128 waterfall); the same pass sums the
    # chain's float32 waterfall over frequency in float64: the pivot that
    # splits the series' error into its two causes
    wf_err = 0.0
    blk = 1 << 11
    ts_f64_of_f32 = np.zeros(wf_o.shape[1], dtype=np.float64)
    for i in range(0, wf_o.shape[0], blk):
        w32 = wf_dev[i:i + blk]
        d = np.abs(w32.astype(np.complex128) - wf_o[i:i + blk])
        wf_err = max(wf_err, float(d.max()))
        ts_f64_of_f32 += (w32.real.astype(np.float64) ** 2
                          + w32.imag.astype(np.float64) ** 2).sum(axis=0)
    ts_raw_max = float(ts_f64_of_f32.max())
    ts_f64_of_f32 -= ts_f64_of_f32.mean()
    ts_err = float(np.abs(ts_dev.astype(np.float64) - ts_o).max())

    # the reference's gates, per quantity
    wf_gate = 1e-5 * wf_scale
    k_ch, t_len = wf_o.shape
    ts_sum_err = float(np.abs(ts_dev.astype(np.float64)
                              - ts_f64_of_f32).max())
    ts_prop_err = float(np.abs(ts_f64_of_f32 - ts_o).max())
    ts_sum_gate, ts_prop_gate = time_series_error_gates(
        k_ch, t_len, ts_raw_max, wf_err)

    out = {
        "probe": "production_oracle",
        "log2n": args.log2n,
        "channels": cfg.spectrum_channel_count,
        "dm": cfg.dm,
        "staged": plan.startswith("staged"),
        "plan": plan,
        "wf_max_rel_err": wf_err / wf_scale if wf_scale else 0.0,
        "ts_max_rel_err": ts_err / ts_scale if ts_scale else 0.0,
        "ts_sum_rel_err": ts_sum_err / ts_scale if ts_scale else 0.0,
        "ts_prop_rel_err": ts_prop_err / ts_scale if ts_scale else 0.0,
        "ts_raw_max": ts_raw_max,
        "gates": {
            "wf": wf_gate / wf_scale if wf_scale else 0.0,
            "ts_sum": ts_sum_gate / ts_scale if ts_scale else 0.0,
            "ts_prop": ts_prop_gate / ts_scale if ts_scale else 0.0,
        },
        "signal_counts": [int(c) for c in np.ravel(counts_dev)],
        "oracle_sk_zapped_rows": int(nzap_o),
        "synth_s": round(synth_s, 1),
        "device_s": round(device_s, 1),
        "oracle_s": round(oracle_s, 1),
        "platform": device.type,
        "device": device_name(device),
        "ok": bool(wf_err <= wf_gate
                   and ts_sum_err <= ts_sum_gate
                   and ts_prop_err <= ts_prop_gate),
    }
    if device.type == "cuda":
        from srtb_tpu_torch.tools.bench import card_line
        out["card"] = card_line()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

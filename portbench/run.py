"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell names a configuration
(``portbench/configs``) and a traffic mix (``portbench/traffic``).  A mix
with ``"loop": "closed"`` drives one stream through the engine
``srtb-torch-main`` runs for the configuration (``Pipeline``, or
``DMSearchPipeline`` when it has a ``dm_list``), fed by the benchmark's
in-memory source as fast as the engine takes it.

A run makes its inputs on the card from ``--seed``, builds the engine,
warms it on the cell's own shapes (that is ``setup_s``), measures for
``--seconds``, then checks what the window produced against the plain
reference (``portbench/check.py``).  ``--trace 1`` runs the window under
torch.profiler and reports the cell's per-layer metrics instead of its
end-to-end ones.  The last line of standard output is the result's JSON.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "srtb_tpu")
# a traced closed loop's phases (seconds): the device's activity alone,
# then (after the untraced rest of --seconds) the host's operators with
# their shapes
TRACED_S = 10.0
SHAPES_S = 5.0


def set_environment(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library already builds under ``build/``), and no
    library that would load JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ the cell

def build_config(spec: dict, traffic: dict, outdir: str,
                 overrides: dict | None = None):
    """The program's Config from the configuration file's settings, the
    traffic's, then ``overrides`` (the CPU tests' small shapes)."""
    from srtb_tpu_torch.config import Config
    cfg = Config()
    settings = dict(spec["cfg"])
    settings.update(traffic.get("cfg", {}))
    settings.update(overrides or {})
    for key, value in settings.items():
        if isinstance(value, list):
            value = ", ".join(str(v) for v in value)
        if not cfg.set_option(key, str(value)):
            raise KeyError(f"unknown setting {key!r}")
    cfg.baseband_output_file_prefix = os.path.join(outdir, "out_")
    # the benchmark's source replaces the reader: a recording replayed
    # (file mode)
    cfg.input_file_path = "portbench:replay"
    return cfg


def draw_positives(traffic: dict, n: int, rng) -> tuple[dict, dict]:
    """The pulses a run carries, drawn from the seed: ``pool`` {slot:
    sample position} (pool segments that carry one, so a share of the
    stream's segments do) and ``extra`` {(0, index): position} (a few
    segments of the window)."""
    lo_pos, hi_pos = n // 16, n - n // 16
    pool = {}
    per = traffic.get("pool_pulse_every", 0)
    slots = traffic["pool_segments"]
    if per:
        for group in range(slots // per):
            slot = group * per + int(rng.integers(per))
            pool[slot] = int(rng.integers(lo_pos, hi_pos))
    extra = {}
    spec = traffic.get("positives")
    if spec:
        lo, hi = spec["index_range"]
        while len(extra) < spec["count"]:
            k = int(rng.integers(lo, hi))
            if (0, k) not in extra and k % slots not in pool:
                extra[(0, k)] = int(rng.integers(lo_pos, hi_pos))
    return pool, extra


class BenchSink:
    """The benchmark's sink, beside the program's writers: when each
    segment's verdict arrived, and the detection it carried."""

    def __init__(self, clock):
        self.clock = clock
        self.records: dict = {}

    def push(self, work, has_signal: bool) -> None:
        t = self.clock()
        import numpy as np
        det = work.detect
        key = getattr(work.segment, "bench_key", None)
        self.records[key] = {
            "t": t, "positive": bool(has_signal),
            "zero": np.asarray(det.zero_count).reshape(-1)[0],
            "counts": np.asarray(det.signal_counts).reshape(-1).copy(),
            "snr": np.asarray(det.snr_peaks).reshape(-1).copy(),
            "series": np.asarray(det.time_series).reshape(-1).copy(),
            "timestamp": work.segment.timestamp,
        }

    def drain(self) -> None:
        pass


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device, root: Path = ROOT, overrides: dict | None = None,
             control: bool = False,
             traffic_overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result (the JSON the CLI prints,
    with the compared numbers last under ``checks``)."""
    import numpy as np
    import torch

    from portbench import manifest as M
    from portbench import sources
    from portbench.trace import Capture, reduce_events

    man = M.load_manifest(root)
    wl = M.workload(man, workload_name)
    spec = M.config(wl["config"], root)
    traffic = dict(M.traffic(wl["traffic"], root), **(traffic_overrides
                                                         or {}))
    try:
        limits = M.limits(workload_name, root)
    except FileNotFoundError:
        limits = {}
    outdir = tempfile.mkdtemp(prefix="portbench_")
    on_card = device.type == "cuda"
    clock = time.perf_counter
    engine = None
    try:
        cfg = build_config(spec, traffic, outdir, overrides)
        seed = int(seed) % (2 ** 63)
        rng = np.random.default_rng(seed)
        pool_pulses, extra = draw_positives(
            traffic, cfg.baseband_input_count, rng)
        bank = sources.SegmentBank(
            cfg, traffic["pool_segments"], seed,
            traffic.get("pulse_amp", 40.0), device, pool_pulses, extra)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        if traffic["loop"] != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        out = _closed_loop(cfg, traffic, bank, seconds, trace, device,
                           clock, Capture, reduce_events)
        engine = out.pop("engine")
        peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
        # the program's state goes before the reference runs
        for e in engine:
            e.close()
        engine = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        from portbench.verify import verify
        checked = verify(cfg, traffic, bank, out, seed, limits, device,
                         control)
        out["info"]["compared"] = len(checked["sample"])
    finally:
        if engine is not None:
            for e in engine:
                try:
                    e.close()
                except Exception:  # noqa: BLE001 - the run already failed
                    pass
        shutil.rmtree(outdir, ignore_errors=True)
    ctx = out["ctx"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in M.cell_metrics(man, workload_name, kind):
        if kind == "end_to_end":
            value = out["e2e"].get(m["name"])
        else:
            value = M.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": int(wl.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": checked["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = ctx["trace"]
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
        out["info"].update(kernel_s=t.kernel_s, unmodeled_s=t.unmodeled_s,
                           reduce_s=t.reduce_s)
    result["checks"] = checked["table"]
    result["_info"] = out.get("info", {})
    return result


def _closed_loop(cfg, traffic, bank, seconds, trace, device, clock,
                 Capture, reduce_events) -> dict:
    from srtb_tpu_torch.pipeline.runtime import DMSearchPipeline, Pipeline

    from portbench import sources
    from portbench.stats import window_rate
    from portbench.trace import DeviceCapture, merge, reduce_device

    src = sources.ReplaySource(bank, clock=clock)
    sink = None
    if cfg.dm_list:
        eng = DMSearchPipeline(cfg, source=src, device=device)
    else:
        eng = Pipeline(cfg, source=src, device=device)
        sink = BenchSink(clock)
        eng.sinks.append(sink)
    # warm-up on the cell's own shapes, from indices the window never uses
    src.arm(-traffic.get("warmup_segments", 4),
            count=traffic.get("warmup_segments", 4))
    eng.run()
    setup_s = clock() - T_PROCESS
    seg0 = eng.stats.segments
    # a traced run measures in three phases: the device capture for
    # TRACED_S, untraced for the engine's own stage seconds, and the full
    # capture for SHAPES_S; each profiler's stop falls between two phases
    # and the events are reduced once the last has ended
    dcap = cap = None
    t0 = clock()
    if trace:
        with DeviceCapture(True, clock) as dcap:
            # the window opens once the profiler runs
            t0 = clock()
            src.arm(0, deadline=t0 + TRACED_S)
            eng.run()
        device_segments = eng.stats.segments - seg0
        # the untraced phase keeps at least SHAPES_S
        stage_seconds = max(seconds - TRACED_S - SHAPES_S, SHAPES_S)
    else:
        stage_seconds = seconds
    seg1 = eng.stats.segments
    t_rest = clock() if trace else t0
    src.arm(src.next_index, deadline=t_rest + stage_seconds)
    eng.run()
    # the engine's own host seconds by stage, of the untraced run
    stage_s = (dict(eng.stats.extras.get("stage_s", {}))
               if sink is not None and eng.stats.segments > seg1 else None)
    t_end = clock()
    rest_segments = eng.stats.segments - seg1
    if trace:
        with Capture(True) as cap:
            src.arm(src.next_index, deadline=clock() + SHAPES_S)
            eng.run()
    run_segments = eng.stats.segments - seg0
    if sink is not None:
        done = {k[1]: r["t"] for k, r in sink.records.items()
                if k is not None and k[1] >= 0}
    else:
        done = {k: t for k, t in src.completions().items() if k >= 0}
    handed = [k for k in src.handed if k >= 0]
    # a traced run's phases end where they end: all it drained counts
    in_window = [k for k, t in done.items()
                 if trace or t <= t0 + seconds]
    n = cfg.baseband_input_count
    # ``segments``: those the device capture's run drained (its busy
    # time's); ``run_segments``: those of the untraced run (its stages')
    ctx = {"segments": len(in_window), "run_segments": rest_segments,
           "rest_s": t_end - t_rest, "stage_s": stage_s}
    if trace:
        summary = reduce_device(dcap.events(), dcap.window_s)
        ctx["trace"] = merge(summary, reduce_events(
            cap.events(), _kernel_geometry(cfg)))
        ctx["segments"] = device_segments
    if sink is not None:
        readings = {k: r for k, r in sink.records.items()
                    if k is not None and k[1] >= 0}
    else:
        from portbench.verify import _port_reading_dm
        from portbench.reference.chain import Geometry
        geo = Geometry.from_cfg(cfg)
        readings = {(0, k): _port_reading_dm(r, geo)
                    for k, r in _dm_records(cfg, bank).items()}
    rate = window_rate(done.values(), t0, seconds, n) / 1e6
    return {
        "engine": [eng],
        # one closed-loop rate under each name a cell may report it by
        # (BENCHMARK.json says which)
        "e2e": {"throughput_msps": rate, "dm_throughput_msps": rate,
                "setup_s": setup_s},
        "attempted": len(handed),
        "failed": len(handed) - len(done),
        "ctx": ctx,
        "readings": readings,
        "in_window": [(0, k) for k in in_window],
        "dumps": sink is not None,
        "prefixes": {0: cfg.baseband_output_file_prefix},
        "info": {"window_s": t_end - t0, "segments_in_window":
                 len(in_window), "run_segments": run_segments,
                 "setup_s": setup_s,
                 "thirds_msps": [window_rate(done.values(), t0 + i * seconds
                                             / 3, seconds / 3, n,
                                             start=t0) / 1e6
                                 for i in range(3)],
                 "longest_gaps": _longest_gaps(done),
                 # the untraced part's own rate, and in a traced run the
                 # device capture's, side by side: the capture's cost
                 "rest_msps": rest_segments * n / max(t_end - t_rest, 1e-9)
                 / 1e6,
                 "device_capture_msps": (
                     device_segments * n / dcap.window_s / 1e6
                     if trace and dcap.window_s > 0 else None),
                 "pulsed": sorted(k for s, k in bank.pulsed)},
    }


def _longest_gaps(done: dict, top: int = 4) -> list:
    """The longest waits between consecutive results, with the index of
    the segment that ended each: where a window stalled."""
    order = sorted(done.items(), key=lambda kv: kv[1])
    gaps = [(round(t1 - t0, 4), k1)
            for (_, t0), (k1, t1) in zip(order, order[1:])]
    return sorted(gaps, reverse=True)[:top]


def _dm_records(cfg, bank) -> dict:
    """The DM search's records of the window, by segment index (its
    timestamp is the index's sample time)."""
    from portbench.sources import EPOCH_NS
    out = {}
    path = cfg.baseband_output_file_prefix + "dm_trials.jsonl"
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            k = (rec["timestamp"] - EPOCH_NS) // bank.segment_ns()
            if k >= 0:
                out[int(k)] = rec
    return out


def _kernel_geometry(cfg) -> dict:
    n = int(cfg.baseband_input_count)
    return {"n": n, "m": n // 2, "nbits": abs(int(cfg.baseband_input_bits)),
            "masked": bool(str(cfg.mitigate_rfi_freq_list).strip())}


# --------------------------------------------------------------- CLI

def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="compare the reference in bfloat16 in the "
                        "program's place (the control of the limits)")
    args = p.parse_args(argv)
    set_environment()
    import torch

    from portbench import manifest as M
    chips = M.workload(M.load_manifest(), args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {power_limit()}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    log(f"info {json.dumps(result.pop('_info'))}")
    print(json.dumps(result), flush=True)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

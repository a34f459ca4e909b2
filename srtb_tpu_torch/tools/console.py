"""Live operator console: the fleet status as a terminal dashboard (port of
``srtb_tpu/tools/console.py``).

Renders :func:`srtb_tpu_torch.obs.status.fleet_status` — pool member
states, per-stream SLO burn, roofline gauges, batch occupancy, the
migration timeline, drift alerts — as fixed-width text that reads at
a glance over ssh.  Two data paths:

- ``--url http://host:port`` polls a running ``gui/server.py``'s
  ``/fleet`` endpoint (the in-process registry view: live gauges +
  store tail);
- ``--store DIR`` reads a rollup-store directory directly — works
  with no server and no live process, e.g. against the store an
  aggregator wrote on another host (live-gauge sections render empty;
  the rollup/timeline sections carry the content).

``--once`` prints one frame and exits (CI smoke);  ``--json`` emits
the raw status dict instead of the rendering (scripting).

Usage::

    python -m srtb_tpu_torch.tools.console --url http://localhost:8080
    python -m srtb_tpu_torch.tools.console --store /obs/store --once
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BAR_WIDTH = 24


def _bar(frac: float, width: int = BAR_WIDTH) -> str:
    frac = min(1.0, max(0.0, float(frac)))
    n = int(round(frac * width))
    return "[" + "#" * n + "-" * (width - n) + "]"


def render(status: dict) -> str:
    """One console frame from a fleet_status dict (missing sections
    render as their empty forms — a thin status is not an error)."""
    lines = []

    devices = status.get("devices") or {}
    pool = status.get("pool") or {}
    lines.append(f"POOL  members={pool.get('members', len(devices))} "
                 f"migrations={pool.get('migrations', 0)} "
                 f"drains={pool.get('device_drains', 0)} "
                 f"reinits={pool.get('device_reinits', 0)}")
    for dev, d in sorted(devices.items()):
        lines.append(f"  {dev:<8} {d.get('state', '?'):<9} "
                     f"lanes={d.get('lanes', 0)} "
                     f"drains={d.get('drains', 0)} "
                     f"migrations={d.get('migrations', 0)}")

    streams = status.get("streams") or {}
    slo = status.get("slo") or {}
    if streams:
        lines.append("STREAMS")
        for name, s in sorted(streams.items()):
            burn = ""
            for obj, st in sorted((slo.get(name) or {}).items()):
                if isinstance(st, dict):
                    burn += (f" {obj}:{st.get('state', '?')}"
                             f"({st.get('burn_fast', 0):.2f}x)")
            lines.append(
                f"  {name:<12} seg={s.get('segments', 0):<6} "
                f"drop={s.get('dropped', 0):<4} "
                f"mig={s.get('migrations', 0):<3} "
                f"roofline={s.get('roofline_frac', 0.0):.3f}"
                f"{burn}")

    roof = status.get("roofline") or {}
    lines.append(f"ROOFLINE {_bar(roof.get('frac', 0.0))} "
                 f"{roof.get('frac', 0.0):.1%} of HBM peak  "
                 f"({roof.get('msamps', 0.0)} Msamp/s, "
                 f"{roof.get('gbps', 0.0)} GB/s)")

    batch = status.get("batch") or {}
    lines.append(f"BATCH occupancy={batch.get('occupancy', 0.0):.2f} "
                 f"seg/dispatch "
                 f"({batch.get('segments', 0)} segments over "
                 f"{batch.get('dispatches', 0)} dispatches)")

    drift = status.get("drift") or {}
    lines.append(f"DRIFT score={drift.get('score', 0.0):.3f} "
                 f"alerts={drift.get('alerts', 0)}")

    store = status.get("store") or {}
    timeline = store.get("timeline") or []
    if timeline:
        lines.append("TIMELINE (fleet events, newest last)")
        for ev in timeline:
            lines.append(f"  t={ev.get('ts', 0.0):>12.3f} "
                         f"{ev.get('kind', '?'):<18} "
                         f"stream={ev.get('stream') or '-':<12} "
                         f"{ev.get('info', '')}")
    digests = store.get("digests") or {}
    if digests:
        lines.append("ROLLUPS (quantiles from the long-horizon store)")
        for key, p in sorted(digests.items()):
            lines.append(f"  {key:<24} p50={p.get('p50', 0):>9.3f} "
                         f"p95={p.get('p95', 0):>9.3f} "
                         f"p99={p.get('p99', 0):>9.3f} "
                         f"n={p.get('n', 0)}")
    return "\n".join(lines) + "\n"


def _fetch(url: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(url.rstrip("/") + "/fleet",
                                timeout=10) as resp:
        return json.loads(resp.read().decode())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", default="",
                     help="gui/server.py base URL (polls /fleet)")
    src.add_argument("--store", default="",
                     help="rollup-store directory (serverless mode)")
    p.add_argument("--once", action="store_true",
                   help="one frame, then exit")
    p.add_argument("--json", action="store_true",
                   help="emit the raw status dict, not the rendering")
    p.add_argument("--interval", type=float, default=2.0)
    args = p.parse_args(argv)
    while True:
        try:
            if args.url:
                status = _fetch(args.url)
            else:
                from srtb_tpu_torch.obs.status import fleet_status
                status = fleet_status(store_dir=args.store)
        except OSError as e:
            print(f"console: status fetch failed: {e}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(status, sort_keys=True))
        else:
            print(render(status), end="")
        if args.once:
            return 0
        time.sleep(max(0.2, args.interval))


if __name__ == "__main__":
    sys.exit(main())

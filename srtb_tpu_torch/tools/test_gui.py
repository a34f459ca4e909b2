"""GUI smoke test: synthetic spectra through the real waterfall service
(port of ``srtb_tpu/tools/test_gui.py``, the reference's ``test-gui``,
ref: src/test-gui.cpp:1-128).

Synthesizes dynamic spectra (drifting tones + noise, and a dispersed-sweep
frame), pushes them through :class:`WaterfallService` in both provider
modes (simple per-segment frames, and the legacy scrolling provider),
rendering on the card unless given ``--device cpu``, writes the PNGs, and
can serve them briefly over the HTTP viewer.

Usage:
  python -m srtb_tpu_torch.tools.test_gui [--out DIR] [--frames N]
         [--streams S] [--scroll-lines K] [--http-port P] [--serve-s SEC]
         [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.utils.logging import log


def synthetic_frame(n_freq: int, n_time: int, seed: int,
                    kind: str = "tones") -> np.ndarray:
    """One synthetic [2, F, T] (re, im) float32 dynamic spectrum, the
    reference's: ``tones`` is noise + three drifting carriers
    (test-gui.cpp's moving peak); ``sweep`` a quadratic frequency sweep,
    the shape of a dispersed pulse after imperfect dedispersion."""
    rng = np.random.default_rng(seed)
    wf = rng.standard_normal((2, n_freq, n_time)).astype(np.float32)
    f = np.arange(n_freq, dtype=np.float32)[:, None]
    t = np.arange(n_time, dtype=np.float32)[None, :]
    if kind == "tones":
        for i in range(3):
            center = (0.2 + 0.3 * i) * n_freq + \
                (n_freq / 8.0) * np.sin(2 * np.pi * (t / n_time + i / 3.0))
            wf[0] += 8.0 * np.exp(-0.5 * ((f - center) / 1.5) ** 2)
    else:
        center = n_freq * (0.9 - 0.8 * (t / n_time) ** 2)
        wf[0] += 10.0 * np.exp(-0.5 * ((f - center) / 2.0) ** 2)
    return wf


def as_waterfall(wf_ri: np.ndarray) -> torch.Tensor:
    """[2, ...] (re, im) float32 -> the engine's complex64 layout."""
    return torch.complex(torch.from_numpy(wf_ri[0]),
                         torch.from_numpy(wf_ri[1]))


def main(argv=None) -> int:
    from srtb_tpu_torch.gui.waterfall import WaterfallService

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="test_gui_out")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--streams", type=int, default=2)
    p.add_argument("--freq", type=int, default=256)
    p.add_argument("--time", type=int, default=512)
    p.add_argument("--scroll-lines", type=int, default=16,
                   help="lines per frame for the scrolling provider pass "
                        "(0 disables it)")
    p.add_argument("--http-port", type=int, default=0)
    p.add_argument("--serve-s", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="render on this device (default: the card)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    base = dict(baseband_input_count=1 << 12, baseband_input_bits=8,
                baseband_reserve_sample=False,
                gui_pixmap_width=640, gui_pixmap_height=360)

    written = []
    # pass 1: simple per-segment provider (SimpleSpectrumImageProvider)
    svc = WaterfallService(Config(**base), args.freq, args.time,
                           out_dir=args.out, device=args.device)
    for i in range(args.frames):
        for s in range(args.streams):
            kind = "sweep" if (i + s) % 3 == 2 else "tones"
            svc.push(as_waterfall(synthetic_frame(
                args.freq, args.time, 97 * i + s, kind)), data_stream_id=s)
            path = svc.render_pending()
            if path:
                written.append(path)

    # pass 2: legacy scrolling provider with the 3n+1 scheduler
    if args.scroll_lines > 0:
        svc2 = WaterfallService(Config(gui_scroll_lines=args.scroll_lines,
                                       **base),
                                args.freq, args.time, out_dir=args.out,
                                device=args.device)
        for i in range(args.frames):
            for s in range(args.streams):
                svc2.push(as_waterfall(synthetic_frame(
                    args.freq, args.time, 31 * i + s)), data_stream_id=s)
            path = svc2.render_pending()
            if path:
                written.append(path)

    uniq = sorted(set(written))
    log.info(f"[test_gui] wrote {len(uniq)} image file(s) under "
             f"{args.out}: {[os.path.basename(u) for u in uniq]}")
    if not uniq:
        log.error("[test_gui] no frames rendered")
        return 1

    if args.http_port:
        from srtb_tpu_torch.gui.server import WaterfallHTTPServer
        server = WaterfallHTTPServer(args.out, port=args.http_port).start()
        log.info(f"[test_gui] serving {args.out} on port "
                 f"{server.port} for {args.serve_s:.0f}s")
        try:
            time.sleep(args.serve_s)
        finally:
            server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

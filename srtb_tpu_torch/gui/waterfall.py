"""Spectrum-waterfall rendering service (port of
``srtb_tpu/gui/waterfall.py``).

The reference's Qt GUI chain (ref: pipeline/spectrum_pipe.hpp
simplify_spectrum_pipe_2 -> gui/spectrum_image_provider.hpp -> QML) made
headless: the device side resamples the segment's dynamic spectrum to
pixmap size, normalizes by twice its average and applies the ARGB colormap
(``ops/spectrum.py``), and the sink is a PNG file per data stream that the
live viewer (``gui/server.py``) serves.  :class:`WaterfallRenderer` does
all of that on the waterfall's device: the power of the engine's complex64
waterfall, the two resample products, the normalization and the colormap;
only the ``[H, W]`` ARGB32 pixmap comes back to the host.  The lossy-tap
semantics of the reference's ``loose_queue_out_functor`` (drop frames when
the consumer is slow, ref: framework/pipe_io.hpp:79-94) are kept in
:class:`WaterfallService`.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from srtb_tpu_torch.ops import spectrum as sp
from srtb_tpu_torch.utils.device import resolve_device

# elements of one power chunk: the square of each half is formed a chunk
# of rows at a time, so no waterfall-sized temporary exists beside the
# power itself
_POWER_CHUNK = 1 << 26


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor (or a numpy array) on ``device``."""
    return torch.as_tensor(x).to(device)


def waterfall_power(wf: torch.Tensor) -> torch.Tensor:
    """complex [F, T] -> float32 power ``re*re + im*im``, each product and
    the sum rounded apart (the reference's ``wf_ri[0]**2 + wf_ri[1]**2``),
    on the waterfall's device."""
    ri = torch.view_as_real(wf)
    out = torch.empty(wf.shape, dtype=torch.float32, device=wf.device)
    rows = max(1, _POWER_CHUNK // max(1, wf.shape[-1]))
    for r in range(0, wf.shape[0], rows):
        re, im = ri[r:r + rows, ..., 0], ri[r:r + rows, ..., 1]
        torch.mul(re, re, out=out[r:r + rows])
        out[r:r + rows] += im * im
    return out


class WaterfallRenderer:
    """The resample + normalize + colormap of one waterfall geometry on
    ``device`` (the card unless the caller asks for the CPU).  The two
    weight matrices are built once, in float64 cast to float32 as the
    reference's, and stay on the device."""

    def __init__(self, in_freq: int, in_time: int, out_h: int, out_w: int,
                 device=None):
        self.device = resolve_device(device)
        sp.check_no_tf32(self.device)
        self.w_freq = torch.from_numpy(
            sp.freq_area_weights(in_freq, out_h)).to(self.device)
        self.w_time = torch.from_numpy(
            sp.time_interp_weights(in_time, out_w)).to(self.device)

    def intensity_power(self, power) -> torch.Tensor:
        """power float32 [F, T] -> the normalized float32 intensity
        [out_h, out_w] the colormap reads, on the device."""
        power = _on(power, self.device).to(torch.float32)
        return sp.normalize_by_average(
            sp.resample_spectrum(power, self.w_freq, self.w_time))

    def intensity(self, wf) -> torch.Tensor:
        """complex waterfall [F, T] -> the float32 intensity."""
        return self.intensity_power(waterfall_power(_on(wf, self.device)))

    def render(self, wf) -> np.ndarray:
        """complex waterfall [F, T] -> ARGB32 uint32 [out_h, out_w]."""
        return sp.generate_pixmap(self.intensity(wf))

    def render_power(self, power) -> np.ndarray:
        """power [F, T] -> ARGB32 uint32 [out_h, out_w]."""
        return sp.generate_pixmap(self.intensity_power(power))


# ----------------------------------------------------------------
# minimal dependency-free PNG writer (RGBA8)
# ----------------------------------------------------------------

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    c = tag + data
    return struct.pack(">I", len(data)) + c + struct.pack(
        ">I", zlib.crc32(c) & 0xFFFFFFFF)


def write_png(path: str, argb: np.ndarray) -> None:
    """Write an ARGB32 uint32 [h, w] array as a PNG file (RGBA8, filter
    byte 0 on every row, zlib level 6), through a temporary file renamed
    into place so that the viewer never serves a partial frame."""
    h, w = argb.shape
    a = ((argb >> 24) & 0xFF).astype(np.uint8)
    r = ((argb >> 16) & 0xFF).astype(np.uint8)
    g = ((argb >> 8) & 0xFF).astype(np.uint8)
    b = (argb & 0xFF).astype(np.uint8)
    rgba = np.stack([r, g, b, a], axis=-1)
    rows = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8),  # filter byte 0 per row
         rgba.reshape(h, w * 4)], axis=1)
    raw = rows.tobytes()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(
            b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
    os.replace(tmp, path)


class RequestSizeScheduler:
    """Adaptive lines-per-update scheduler of the legacy provider: grow
    3n+1 when the consumer starved last round, halve (min 1) when it had
    enough (ref: gui/spectrum_image_provider.hpp:79-102)."""

    def __init__(self):
        self._size = 1

    def set_last_size_too_few(self, too_few: bool) -> None:
        self._size = (3 * self._size + 1) if too_few else max(
            1, self._size // 2)

    def get_next_request_size(self) -> int:
        return self._size


class ScrollingWaterfall:
    """Legacy scrolling-waterfall provider, headless (ref:
    gui/spectrum_image_provider.hpp:118-330): each pushed power spectrum
    becomes one pixmap line (frequency along x); lines scroll through a
    persistent image, newest at the top; the :class:`RequestSizeScheduler`
    decides how many pending lines one update consumes.  Host state: the
    lines are [in_freq] vectors and the image [height, width]."""

    def __init__(self, in_freq: int, width: int, height: int):
        self.width = width
        self.height = height
        # area-weighted frequency -> pixel resample, the same weights as
        # the renderer's
        self._w_freq = sp.freq_area_weights(in_freq, width).T
        self._img = np.zeros((height, width), dtype=np.float32)
        self._pending: list[np.ndarray] = []
        self.scheduler = RequestSizeScheduler()
        self.lines_total = 0

    def push_spectrum(self, power: np.ndarray) -> None:
        """Queue one [in_freq] power spectrum as a future line."""
        self._pending.append(np.asarray(power, dtype=np.float32))

    def consume(self) -> int:
        """Scroll in up to request_size pending lines (one UI update);
        returns the number of lines consumed and adapts the scheduler."""
        want = self.scheduler.get_next_request_size()
        take = min(want, len(self._pending))
        if take:
            lines = np.stack(self._pending[:take]) @ self._w_freq
            del self._pending[:take]
            # scroll down, newest line at the top (ref: update_pixmap
            # scrolls dy=+lines and paints new lines at y=0)
            self._img = np.roll(self._img, take, axis=0)
            keep = lines[-self.height:]
            self._img[:keep.shape[0]] = keep[::-1]
            self.lines_total += take
        # grow 3n+1 whenever the full request was satisfied, halve when
        # the queue ran dry mid-request (ref:
        # spectrum_image_provider.hpp:218-230)
        self.scheduler.set_last_size_too_few(take >= want)
        return take

    def render(self) -> np.ndarray:
        """ARGB32 [height, width] of the current scroll window, normalized
        over the rows that have received data only."""
        filled = min(self.lines_total, self.height)
        if filled == 0:
            return sp.generate_pixmap(torch.from_numpy(self._img))
        avg = float(self._img[:filled].mean())
        coeff = 1.0 / (2.0 * avg) if avg > np.finfo(np.float32).eps else 1.0
        return sp.generate_pixmap(
            torch.from_numpy(self._img * np.float32(coeff)))


def _stream_slice(wf: torch.Tensor, stream: int) -> torch.Tensor:
    """[S, F, T] -> this stream's [F, T].  ``data_stream_id`` indexes S
    only when S > 1 (several streams in one segment); a one-stream
    segment's id names the receiver's pane, not an index (the
    reference's rule, for all three render paths)."""
    if wf.ndim == 3:
        return wf[stream if wf.shape[0] > 1 else 0]
    return wf


class WaterfallService:
    """Per-stream waterfall file sink with lossy-frame semantics: only the
    most recent segment is rendered; older frames are dropped if rendering
    lags (ref: loose_queue_out_functor, framework/pipe_io.hpp:79-94).

    Modes, as the reference's:
    - simple (default): each frame ``waterfall_s<stream>_<n:06d>.png`` is
      one whole segment's dynamic spectrum;
    - ``spectrum_sum_count > 1``: the power of that many segments of a
      stream is summed (on the device) before one frame is drawn;
    - ``gui_scroll_lines > 0``: each segment adds that many time-averaged
      spectrum lines to a persistent scrolling image, written as
      ``waterfall_s<stream>_scroll.png`` after every update.

    Waterfalls are the engine's complex64 ``[S, F, T]`` (or one stream's
    ``[F, T]``); every mode forms their power on the renderer's device.
    """

    def __init__(self, cfg, in_freq: int, in_time: int,
                 out_dir: str = ".", fmt: str = "png", device=None):
        self.cfg = cfg
        self.out_dir = out_dir
        self.fmt = fmt
        self.renderer = WaterfallRenderer(
            in_freq, in_time, cfg.gui_pixmap_height, cfg.gui_pixmap_width,
            device=device)
        self.frame_counter: dict[int, int] = {}
        self._pending = None
        # scroll mode: every stream with queued-but-unrendered lines
        self._pending_scroll: set[int] = set()
        # sum several segments' power before drawing (ref: config.hpp:
        # 196-200 spectrum_sum_count)
        self.sum_count = max(1, cfg.spectrum_sum_count)
        self._accum: dict[int, tuple[int, torch.Tensor | None]] = {}
        self.scroll_lines = max(0, cfg.gui_scroll_lines)
        self._scrollers: dict[int, ScrollingWaterfall] = {}
        self._in_freq = in_freq

    def _power(self, wf, stream: int) -> torch.Tensor:
        """The stream's power [F, T] on the renderer's device."""
        wf = _stream_slice(_on(wf, self.renderer.device), stream)
        return waterfall_power(wf)

    def _scroller(self, stream: int) -> ScrollingWaterfall:
        if stream not in self._scrollers:
            self._scrollers[stream] = ScrollingWaterfall(
                self._in_freq, self.cfg.gui_pixmap_width,
                self.cfg.gui_pixmap_height)
        return self._scrollers[stream]

    def _push_scroll(self, wf, stream: int) -> None:
        power = self._power(wf, stream)
        k = min(self.scroll_lines, power.shape[-1])
        # one time-averaged spectrum line per chunk (np.array_split's
        # chunks), averaged on the device; only the [k, F] lines move
        lines = torch.stack([c.mean(dim=-1) for c in
                             torch.tensor_split(power, k, dim=-1)])
        sw = self._scroller(stream)
        for line in lines.cpu().numpy():
            sw.push_spectrum(line)
        self._pending_scroll.add(stream)

    def push(self, wf, data_stream_id: int = 0) -> None:
        if self.scroll_lines:
            self._push_scroll(wf, data_stream_id)
            return
        if self.sum_count > 1:
            power = self._power(wf, data_stream_id)
            n, acc = self._accum.get(data_stream_id, (0, None))
            n, acc = n + 1, power if acc is None else acc + power
            if n < self.sum_count:
                self._accum[data_stream_id] = (n, acc)
                return
            self._accum[data_stream_id] = (0, None)
            self._pending = (acc, data_stream_id)
            return
        # lossy tap: replace any unrendered frame
        self._pending = (wf, data_stream_id)

    def render_pending(self) -> str | None:
        if self.scroll_lines:
            # render every stream with queued lines; return the last path
            # (None when nothing was consumed anywhere)
            path = None
            for stream in sorted(self._pending_scroll):
                sw = self._scroller(stream)
                if sw.consume() == 0:
                    continue
                p = os.path.join(self.out_dir,
                                 f"waterfall_s{stream}_scroll.{self.fmt}")
                write_png(p, sw.render())
                path = p
            self._pending_scroll.clear()
            return path
        if self._pending is None:
            return None
        wf, stream = self._pending
        self._pending = None
        wf = _stream_slice(_on(wf, self.renderer.device), stream)
        if wf.is_complex():
            pix = self.renderer.render(wf)
        else:  # a summed power frame
            pix = self.renderer.render_power(wf)
        n = self.frame_counter.get(stream, 0)
        self.frame_counter[stream] = n + 1
        path = os.path.join(self.out_dir,
                            f"waterfall_s{stream}_{n:06d}.{self.fmt}")
        write_png(path, pix)
        return path

"""The port's display path against the JAX package's: the waterfall
weights, resample, colormap and PNG writer (``ops/spectrum.py``,
``gui/waterfall.py``), the waterfall service in its three modes, the live
viewer (``gui/server.py``), the supervisor's restart budget, and the
display tools (``srtb-torch-make-baseband``, ``-plot-spectrum``,
``-plot-tim``, ``test_gui``) and the running-mean quantizer.  The same
inputs, made from numpy seeds, go through both packages; the reference
runs in its own interpreter (``test_torch_ref.py``).

Pixmaps are compared under the boundary rule: equal bit for bit, except
at pixels whose float64 intensity lies within ``BOUNDARY`` of a colour
channel's truncation step or of the [0, 1] edges, where two float32
computations may round to either side.  Float intensities are held to
the float64 computation within 1e-5 relative."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.gui import waterfall as GW
from srtb_tpu_torch.gui.server import WaterfallHTTPServer
from srtb_tpu_torch.ops import running_mean as RM
from srtb_tpu_torch.ops import spectrum as sp
from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.tools import make_baseband, plot_spectrum, plot_tim
from srtb_tpu_torch.tools import test_gui
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import (block_matplotlib, run_printing, run_reference,
                            scroll_script, supervisor_script,
                            viewer_responses)

BOUNDARY = 1e-5
RTOL = 1e-5

# (kind, in, out): the weights, the J1644-4559 geometry's non-integer
# ratios (2048 -> 1080 rows, 2^15 -> 1920 columns) among them
WEIGHTS = {"freq_2048_1080": ("freq", 2048, 1080),
           "time_32768_1920": ("time", 1 << 15, 1920),
           "freq_64_48": ("freq", 64, 48), "time_256_64": ("time", 256, 64),
           "freq_37_1080": ("freq", 37, 1080), "time_96_1920": ("time", 96,
                                                                1920)}
# the render: [F, T] -> [H, W]
F_IN, T_IN, H_OUT, W_OUT = 64, 256, 48, 64
# the service: the waterfall geometry and its pixmap
SVC_F, SVC_T = 32, 128
SVC_FIELDS = dict(baseband_input_count=1 << 12, baseband_input_bits=8,
                  baseband_reserve_sample=False, gui_pixmap_width=40,
                  gui_pixmap_height=24)
SVC_MODES = {"simple": {}, "sum": {"spectrum_sum_count": 2},
             "scroll": {"gui_scroll_lines": 5}}
SVC_SEGMENTS = 4
NBITS = (1, 2, 4, 8, 16)
VIEWER_PATHS = ["/", "/index.html", "/frames.json",
                "/waterfall_s0_000001.png", "/waterfall_s1_000000.png",
                "/missing.png", "/notes.txt", "/metrics", "/metrics.json",
                "/healthz", "/fleet"]
SUPERVISOR_TIMES = [0.0, 1.0, 2.0, 3.0, 30.0, 61.5, 62.0, 200.0, 201.0]


def wf_ri_of(seed: int, shape) -> np.ndarray:
    """A [2, ...] (re, im) float32 waterfall of unit noise, a few channels
    lit and one zeroed (a zapped channel)."""
    rng = np.random.default_rng(seed)
    wf = rng.standard_normal((2, *shape)).astype(np.float32)
    wf[..., 3, :] *= 4.0
    wf[..., 5, :] = 0.0
    return wf


def complex_of(wf_ri: np.ndarray) -> torch.Tensor:
    return torch.complex(torch.from_numpy(wf_ri[0]),
                         torch.from_numpy(wf_ri[1]))


def power64(wf_ri: np.ndarray) -> np.ndarray:
    x = wf_ri.astype(np.float64)
    return x[0] * x[0] + x[1] * x[1]


def normalized64(img: np.ndarray) -> np.ndarray:
    avg = img.mean()
    return img / (2.0 * avg) if avg > np.finfo(np.float32).eps else img


def intensity64(power: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The float64 render of a power array: float64 weights, products and
    normalization."""
    in_h, in_w = power.shape
    w_freq = sp.freq_area_weights(in_h, out_h, dtype=np.float64)
    w_time = sp.time_interp_weights(in_w, out_w, dtype=np.float64)
    return normalized64(w_freq @ power @ w_time)


def pixmap64(x: np.ndarray) -> np.ndarray:
    """The colormap in float64 arithmetic (int64 words)."""
    c0 = [(sp.COLOR_0 >> s) & 0xFF for s in (24, 16, 8, 0)]
    c1 = [(sp.COLOR_1 >> s) & 0xFF for s in (24, 16, 8, 0)]
    xc = np.clip(x, 0.0, 1.0)
    out = np.zeros(x.shape, dtype=np.int64)
    for shift, a, b in zip((24, 16, 8, 0), c0, c1):
        out |= ((1.0 - xc) * a + xc * b).astype(np.int64) << shift
    return np.where((x >= 0) & (x <= 1), out, sp.COLOR_OVERFLOW)


SHIFTS = (24, 16, 8, 0)  # A, R, G, B


def near_boundary(x64: np.ndarray, x64_other=None) -> np.ndarray:
    """[4, ...] (A, R, G, B): where the channel's value may differ between
    two float32 computations of an intensity whose float64 value is
    ``x64`` (or lies between ``x64`` and ``x64_other``, two computations'
    float64 values): within BOUNDARY of one of the channel's truncation
    steps or of the [0, 1] edges.  The alpha channel's lerp is the
    constant 255, a truncation step at every intensity, so its float32
    value rounds to 255 or just below (alpha 254) by the intensity's last
    bits."""
    other = x64 if x64_other is None else x64_other
    lo = np.minimum(x64, other) - BOUNDARY
    hi = np.maximum(x64, other) + BOUNDARY
    p_lo, p_hi = pixmap64(lo), pixmap64(hi)
    near = np.stack([((p_lo >> s) & 0xFF) != ((p_hi >> s) & 0xFF)
                     for s in SHIFTS])
    near |= ((lo >= 0) & (lo <= 1)) != ((hi >= 0) & (hi <= 1))
    near[0] |= (x64 >= 0) & (x64 <= 1)
    return near


def assert_pixmaps_match(got: np.ndarray, want: np.ndarray,
                         x64: np.ndarray, what: str,
                         x64_other=None) -> int:
    """The boundary rule, channel by channel (an in-range alpha may be
    254 or 255 on either side); returns the count of pixels where a
    channel differs at a boundary."""
    assert got.dtype == want.dtype == np.uint32, what
    assert got.shape == want.shape == x64.shape, what
    near = near_boundary(x64, x64_other)
    diff = np.stack([((got >> s) & 0xFF) != ((want >> s) & 0xFF)
                     for s in SHIFTS])
    alpha_ok = np.isin(got >> 24, (254, 255)) & np.isin(want >> 24,
                                                        (254, 255))
    near[0] &= alpha_ok | ((x64 - BOUNDARY < 0) | (x64 + BOUNDARY > 1))
    bad = (diff & ~near).any(axis=0)
    assert not bad.any(), (f"{what}: {int(bad.sum())} pixels differ away "
                           f"from a boundary, at {np.argwhere(bad)[:5]}")
    return int(diff.any(axis=0).sum())


def assert_relative(got: np.ndarray, want64: np.ndarray, what: str) -> None:
    err = np.abs(got.astype(np.float64) - want64)
    assert (err <= RTOL * np.abs(want64)).all(), \
        f"{what}: relative error {float((err / np.abs(want64)).max())}"


def read_png(data) -> np.ndarray:
    """The ARGB32 uint32 [h, w] pixmap of a PNG as ``write_png`` writes
    it (one IDAT, RGBA8, filter byte 0)."""
    data = bytes(np.asarray(data, dtype=np.uint8))
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         dtype=np.uint8).reshape(h, 1 + 4 * w)
    assert (rows[:, 0] == 0).all()
    rgba = rows[:, 1:].reshape(h, w, 4).astype(np.uint32)
    return (rgba[..., 3] << 24) | (rgba[..., 0] << 16) | \
        (rgba[..., 1] << 8) | rgba[..., 2]


def pixmap_intensities() -> np.ndarray:
    """Intensities for the colormap: random in [-0.25, 1.25], exact 0, 1,
    negative values, values above 1, NaN and the channel's own steps."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-0.25, 1.25, size=4080).astype(np.float32)
    special = np.array([0.0, 1.0, -0.0, -1e-30, -0.5, -3.0, 1.0000001,
                        1.5, 7.0, np.nan, np.inf, -np.inf, 0.5, 0.25,
                        1e-30, 0.99999994], dtype=np.float32)
    steps = (np.arange(256, dtype=np.float32) / 255.0).astype(np.float32)
    return np.concatenate([x, special, steps]).reshape(-1, 32)


# ------------------------------------------------------------ the models

class ScrollModel:
    """A float64 model of ``ScrollingWaterfall`` (the same schedule)."""

    def __init__(self, in_freq: int, width: int, height: int):
        self.w = sp.freq_area_weights(in_freq, width, dtype=np.float64).T
        self.img = np.zeros((height, width))
        self.height = height
        self.pending: list = []
        self.size = 1
        self.total = 0

    def consume(self) -> int:
        take = min(self.size, len(self.pending))
        if take:
            lines = np.stack(self.pending[:take]) @ self.w
            del self.pending[:take]
            self.img = np.roll(self.img, take, axis=0)
            keep = lines[-self.height:]
            self.img[:keep.shape[0]] = keep[::-1]
            self.total += take
        self.size = 3 * self.size + 1 if take >= self.size else max(
            1, self.size // 2)
        return take

    def intensity(self) -> np.ndarray:
        filled = min(self.total, self.height)
        if filled == 0:
            return self.img
        avg = self.img[:filled].mean()
        return self.img / (2.0 * avg) if \
            avg > np.finfo(np.float32).eps else self.img


def service_model(mode: str, pushes: list, cfg: Config) -> dict:
    """The float64 intensity of every file the service writes in ``mode``
    for ``pushes`` (wf_ri [2, S, F, T], stream), by file name (the last
    write of a name wins)."""
    h, w = cfg.gui_pixmap_height, cfg.gui_pixmap_width
    out, counters, accum, scrollers = {}, {}, {}, {}

    def frame(stream, power):
        n = counters.get(stream, 0)
        counters[stream] = n + 1
        out[f"waterfall_s{stream}_{n:06d}.png"] = intensity64(power, h, w)

    for wf_ri, stream in pushes:
        s = stream if wf_ri.shape[1] > 1 else 0
        power = power64(wf_ri[:, s])
        if mode == "scroll":
            sw = scrollers.setdefault(stream, ScrollModel(SVC_F, w, h))
            k = min(cfg.gui_scroll_lines, power.shape[-1])
            sw.pending += [c.mean(axis=-1)
                           for c in np.array_split(power, k, axis=-1)]
            if sw.consume():
                out[f"waterfall_s{stream}_scroll.png"] = sw.intensity()
        elif mode == "sum":
            n, acc = accum.get(stream, (0, 0.0))
            n, acc = n + 1, acc + power
            if n < cfg.spectrum_sum_count:
                accum[stream] = (n, acc)
            else:
                accum[stream] = (0, 0.0)
                frame(stream, acc)
        else:
            frame(stream, power)
    return out


def service_pushes(streams: int) -> list:
    """SVC_SEGMENTS segments of S streams; the pushes alternate data
    stream ids 0 and 1 (an index of S = 2, a pane of S = 1)."""
    return [(wf_ri_of(100 + i, (streams, SVC_F, SVC_T)), i % 2)
            for i in range(SVC_SEGMENTS)]


def scroll_steps() -> list:
    rng = np.random.default_rng(5)
    ops = "ppcpppcccppppppcpcppppppppppccccpc"
    return [("push", rng.exponential(size=SVC_F).astype(np.float32))
            if op == "p" else ("consume", None) for op in ops]


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """A viewer directory: two streams' frames, a scroll frame and a file
    the viewer must not list."""
    d = tmp_path_factory.mktemp("viewer")
    rng = np.random.default_rng(9)
    for name in ("waterfall_s0_000000.png", "waterfall_s0_000001.png",
                 "waterfall_s1_000000.png", "waterfall_s0_scroll.png"):
        GW.write_png(str(d / name), rng.integers(
            0, 1 << 32, size=(6, 9), dtype=np.uint64).astype(np.uint32))
    (d / "notes.txt").write_text("not a frame\n")
    return d


@pytest.fixture(scope="module")
def ref(tmp_path_factory, frames_dir):
    tmp = tmp_path_factory.mktemp("ref_display")
    (tmp / "empty").mkdir()
    jobs = []
    for name, (kind, n_in, n_out) in WEIGHTS.items():
        fn = "time_interp_weights" if kind == "time" else \
            "freq_area_weights"
        jobs.append({"key": f"weights/{name}",
                     "fn": f"srtb_tpu.ops.spectrum:{fn}",
                     "args": [n_in, n_out]})
    wf = wf_ri_of(1, (F_IN, T_IN))
    power = wf[0] ** 2 + wf[1] ** 2
    w_freq = sp.freq_area_weights(F_IN, H_OUT)
    w_time = sp.time_interp_weights(T_IN, W_OUT)
    jobs += [
        {"key": "resample", "fn": "srtb_tpu.ops.spectrum:resample_spectrum",
         "args": [power, w_freq, w_time]},
        {"key": "render", "fn": "test_torch_ref:render_waterfall",
         "args": [wf, H_OUT, W_OUT]},
        {"key": "pixmap", "fn": "srtb_tpu.ops.spectrum:generate_pixmap",
         "args": [pixmap_intensities()]},
        {"key": "png", "fn": "test_torch_ref:png_bytes",
         "args": [np.random.default_rng(3).integers(
             0, 1 << 32, size=(17, 23), dtype=np.uint64).astype(np.uint32),
             str(tmp / "ref.png")]},
        {"key": "scroll", "fn": "test_torch_ref:ref_scroll_script",
         "args": [SVC_F, 40, 24, scroll_steps()]},
        {"key": "viewer", "fn": "test_torch_ref:ref_viewer_responses",
         "args": [str(frames_dir), VIEWER_PATHS]},
        {"key": "viewer_empty", "fn": "test_torch_ref:ref_viewer_responses",
         "args": [str(tmp / "empty"), ["/", "/frames.json"]]},
        {"key": "supervisor", "fn": "test_torch_ref:ref_supervisor_script",
         "args": [3, 60.0, SUPERVISOR_TIMES]},
    ]
    for mode, over in SVC_MODES.items():
        for streams in (1, 2):
            out = tmp / f"svc_{mode}_{streams}"
            out.mkdir()
            jobs.append({"key": f"svc/{mode}_{streams}",
                         "fn": "test_torch_ref:ref_waterfall_service",
                         "args": [dict(SVC_FIELDS, **over), SVC_F, SVC_T,
                                  service_pushes(streams), str(out)]})
    for nbits in NBITS:
        jobs.append({"key": f"baseband/{nbits}",
                     "fn": "test_torch_ref:ref_make_baseband",
                     "args": [make_baseband_argv(tmp / f"ref_{nbits}.bin",
                                                 nbits)]})
    npy = tmp / "plot" / "out_0.0.npy"
    npy.parent.mkdir()
    np.save(npy, complex_of(wf_ri_of(4, (16, 48))).numpy())
    jobs.append({"key": "plot_spectrum",
                 "fn": "test_torch_ref:ref_plot_spectrum_fallback",
                 "args": [str(npy)]})
    tim = tmp / "plot" / "out_0.1.tim"
    np.random.default_rng(6).standard_normal(300).astype("<f4").tofile(tim)
    jobs.append({"key": "plot_tim", "fn": "test_torch_ref:ref_plot_tim",
                 "args": [[str(tim)], False]})
    data = np.random.default_rng(8).integers(0, 256, size=(192, 6)).astype(
        np.float32)
    for window in (8, 16):
        ave = data[:window].mean(axis=0)
        jobs.append({"key": f"running_mean/{window}",
                     "fn": "test_torch_ref:ref_running_mean",
                     "args": [data, window, ave]})
    gui_out = tmp / "test_gui"
    jobs.append({"key": "test_gui", "fn": "srtb_tpu.tools.test_gui:main",
                 "args": [gui_tool_argv(gui_out)]})
    res = run_reference(jobs, tmp)
    res["tmp"] = tmp
    res["test_gui_files"] = sorted(os.listdir(gui_out))
    return res


def make_baseband_argv(out, nbits: int) -> list:
    return ["--out", str(out), "--n", "2 ** 16", "--freq_low", "1405",
            "--bandwidth", "64", "--dm", "60", "--pulses",
            "2**14, 3*2**14", "--nbits", str(nbits), "--seed", "3"]


def gui_tool_argv(out) -> list:
    return ["--out", str(out), "--frames", "3", "--streams", "2", "--freq",
            "32", "--time", "64", "--scroll-lines", "4"]


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("name", WEIGHTS)
def test_weights_bit_for_bit(ref, name):
    kind, n_in, n_out = WEIGHTS[name]
    fn = sp.time_interp_weights if kind == "time" else sp.freq_area_weights
    got = fn(n_in, n_out)
    want = ref[f"weights/{name}"]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_resample_spectrum(ref):
    wf = wf_ri_of(1, (F_IN, T_IN))
    power = wf[0] ** 2 + wf[1] ** 2
    got = sp.resample_spectrum(
        torch.from_numpy(power),
        torch.from_numpy(sp.freq_area_weights(F_IN, H_OUT)),
        torch.from_numpy(sp.time_interp_weights(T_IN, W_OUT))).numpy()
    want64 = sp.resample_oracle(power.astype(np.float64), H_OUT, W_OUT)
    assert_relative(got, want64, "port resample vs the per-pixel oracle")
    assert_relative(ref["resample"], want64, "reference resample")
    f64 = (sp.freq_area_weights(F_IN, H_OUT, dtype=np.float64)
           @ power.astype(np.float64)
           @ sp.time_interp_weights(T_IN, W_OUT, dtype=np.float64))
    np.testing.assert_allclose(f64, want64, rtol=1e-12)


def test_render(ref):
    """The whole render at 64 x 256 -> 48 x 64: the intensity within 1e-5
    of float64, the pixmap the reference's under the boundary rule."""
    wf = wf_ri_of(1, (F_IN, T_IN))
    r = GW.WaterfallRenderer(F_IN, T_IN, H_OUT, W_OUT, device="cpu")
    x64 = intensity64(power64(wf), H_OUT, W_OUT)
    got_x = r.intensity(complex_of(wf)).numpy()
    assert got_x.dtype == np.float32
    assert_relative(got_x, x64, "port intensity")
    assert_relative(ref["render/intensity"], x64, "reference intensity")
    got = r.render(complex_of(wf))
    assert_pixmaps_match(got, ref["render/pixmap"], x64, "render")
    # the same pixmap from the power frame
    power = torch.from_numpy(wf[0] ** 2 + wf[1] ** 2)
    assert np.array_equal(r.render_power(power), got)


def test_generate_pixmap_bit_for_bit(ref):
    x = pixmap_intensities()
    got = sp.generate_pixmap(torch.from_numpy(x))
    want = ref["pixmap"]
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    flat = got.reshape(-1)
    overflow = ~((x >= 0) & (x <= 1)).reshape(-1)
    assert (flat[overflow] == sp.COLOR_OVERFLOW).all()
    assert (flat[x.reshape(-1) == 0] == sp.COLOR_0).all()
    assert (flat[x.reshape(-1) == 1] == sp.COLOR_1).all()


def test_write_png_bytes(ref, tmp_path):
    argb = np.random.default_rng(3).integers(
        0, 1 << 32, size=(17, 23), dtype=np.uint64).astype(np.uint32)
    path = tmp_path / "port.png"
    GW.write_png(str(path), argb)
    got = np.fromfile(path, dtype=np.uint8)
    assert np.array_equal(got, ref["png/bytes"])
    assert np.array_equal(read_png(got), argb)
    assert not (tmp_path / "port.png.tmp").exists()


def test_scrolling_waterfall(ref):
    """The scheduler's request sizes, the consumed counts, lines_total and
    the image over a push/consume script."""
    got = scroll_script(GW.ScrollingWaterfall, SVC_F, 40, 24,
                        scroll_steps())
    for key in ("sizes", "taken", "totals"):
        assert np.array_equal(got[key], ref[f"scroll/{key}"]), key
    model = ScrollModel(SVC_F, 40, 24)
    for op, arg in scroll_steps():
        if op == "push":
            model.pending.append(arg.astype(np.float64))
        else:
            model.consume()
    assert model.total == got["totals"][-1]
    assert_pixmaps_match(got["render"], ref["scroll/render"],
                         model.intensity(), "scroll render")


@pytest.mark.parametrize("streams", (1, 2))
@pytest.mark.parametrize("mode", SVC_MODES)
def test_waterfall_service(ref, tmp_path, mode, streams):
    """The service in each mode, on one- and two-stream segments: the same
    returned paths and files, and their pixmaps under the boundary rule
    (float64 model of the mode)."""
    cfg = Config(**SVC_FIELDS, **SVC_MODES[mode])
    pushes = service_pushes(streams)
    svc = GW.WaterfallService(cfg, SVC_F, SVC_T, out_dir=str(tmp_path),
                              device="cpu")
    returned = []
    for wf_ri, stream in pushes:
        svc.push(torch.complex(torch.from_numpy(wf_ri[0]),
                               torch.from_numpy(wf_ri[1])), stream)
        returned.append(os.path.basename(svc.render_pending() or ""))
    key = f"svc/{mode}_{streams}"
    assert returned == ref[f"{key}/returned"].tolist()
    names = sorted(os.listdir(tmp_path))
    assert names == ref[f"{key}/files"].tolist()
    model = service_model(mode, pushes, cfg)
    assert sorted(model) == names
    near = 0
    for name in names:
        got = read_png(np.fromfile(tmp_path / name, dtype=np.uint8))
        want = read_png(ref[f"{key}/png/{name}"])
        near += assert_pixmaps_match(got, want, model[name],
                                     f"{mode} {name}")
    print(f"{mode}, S = {streams}: {len(names)} files, {near} pixels "
          "differ at a boundary")


def _sub(res: dict, key: str) -> dict:
    """Reference results under ``key/``, the prefix dropped."""
    return {k[len(key) + 1:]: v for k, v in res.items()
            if isinstance(k, str) and k.startswith(key + "/")}


def _response(res: dict, i: int) -> tuple:
    res = {**res, **{f"{k}/{kk}": vv for k, v in res.items()
                     if isinstance(v, dict) for kk, vv in v.items()}}
    return (int(res[f"{i}/status"]), str(res[f"{i}/type"]),
            bytes(res[f"{i}/body"]))


def test_viewer(ref, frames_dir):
    """The viewer on an OS-chosen port against the reference's on the same
    directory: the page, /frames.json and the frames byte for byte, 404
    for a missing or non-frame file; /metrics, /metrics.json and /healthz
    with the reference's status and content types (their bodies are each
    process's own registry: the Prometheus text, the snapshot, an idle
    pipeline's health), and 501 naming ROADMAP A8c for /fleet; ``stop()``
    joins the thread."""
    metrics.reset()
    got = viewer_responses(WaterfallHTTPServer, str(frames_dir),
                           VIEWER_PATHS)
    assert got["thread_ended"]
    for i, path in enumerate(VIEWER_PATHS):
        status, ctype, body = _response(got, i)
        if path == "/fleet":
            assert status == 501 and "ROADMAP A8c" in body.decode()
            continue
        if path in ("/metrics", "/metrics.json", "/healthz"):
            want = _response(_sub(ref, "viewer"), i)
            assert (status, ctype) == want[:2] == (200, ctype), path
            text = body.decode()
            if path == "/metrics":
                assert ctype == "text/plain; version=0.0.4"
                assert "# TYPE srtb_elapsed_s gauge" in text
            elif path == "/metrics.json":
                assert "elapsed_s" in json.loads(text)
            else:
                assert json.loads(text)["status"] == "idle"
            continue
        assert (status, ctype, body) == _response(_sub(ref, "viewer"),
                                                  i), path
        if path.endswith(".png") and status == 200:
            assert body == (frames_dir / path[1:]).read_bytes()
    assert _response(got, VIEWER_PATHS.index("/missing.png"))[0] == 404
    assert b"waterfall_s0_scroll" not in _response(got, 2)[2]
    # a directory without frames: the waiting page and no streams
    empty = viewer_responses(WaterfallHTTPServer, str(ref["tmp"] / "empty"),
                             ["/", "/frames.json"])
    want = _sub(ref, "viewer_empty")
    for i in range(2):
        assert _response(empty, i) == _response(want, i)
    assert b"no frames yet" in _response(empty, 0)[2]


@pytest.mark.parametrize("nbits", NBITS)
def test_make_baseband_bytes(ref, tmp_path, nbits):
    out = tmp_path / "port.bin"
    assert make_baseband.main(make_baseband_argv(out, nbits)) == 0
    assert int(ref[f"baseband/{nbits}/rc"]) == 0
    got = np.fromfile(out, dtype=np.uint8)
    want = ref[f"baseband/{nbits}/bytes"]
    assert got.size == (1 << 16) * nbits // 8
    assert np.array_equal(got, want)


def test_plot_spectrum_fallback(ref, tmp_path):
    """matplotlib blocked: the port's fallback PNG equals the reference's
    byte for byte (its pixmap coloured on the CPU here)."""
    npy = tmp_path / "out_0.0.npy"
    np.save(npy, complex_of(wf_ri_of(4, (16, 48))).numpy())
    with block_matplotlib():
        out = plot_spectrum.plot_one(str(npy), device="cpu")
    assert os.path.basename(out) == str(ref["plot_spectrum/name"])
    assert np.array_equal(np.fromfile(out, dtype=np.uint8),
                          ref["plot_spectrum/bytes"])
    power = np.abs(np.load(npy)) ** 2
    assert np.array_equal(read_png(np.fromfile(out, dtype=np.uint8)),
                          plot_spectrum.fallback_pixmap(power, "cpu"))


def test_plot_spectrum_cli(tmp_path):
    """``main`` takes ``--device`` and globs: one image a file, its path
    printed (matplotlib blocked: the port's own renderer)."""
    for i in range(2):
        np.save(tmp_path / f"out_{i}.0.npy",
                complex_of(wf_ri_of(i, (8, 16))).numpy())
    res = run_printing(plot_spectrum.main,
                       ["--device", "cpu", str(tmp_path / "*.npy")],
                       matplotlib=False)
    assert res["rc"] == 0
    assert res["stdout"].split() == [str(tmp_path / f"out_{i}.0.npy.png")
                                     for i in range(2)]


def test_plot_tim(ref):
    """Without matplotlib the printed summary equals the reference's; with
    it (where importable), a PNG beside the series."""
    tim = str(ref["tmp"] / "plot" / "out_0.1.tim")
    got = run_printing(plot_tim.main, [tim], matplotlib=False)
    assert got["rc"] == int(ref["plot_tim/rc"]) == 0
    assert got["stdout"] == str(ref["plot_tim/stdout"])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    got = run_printing(plot_tim.main, [tim], matplotlib=True)
    assert got["stdout"].split() == [tim + ".png"]
    assert os.path.getsize(tim + ".png") > 0


@pytest.mark.parametrize("window", (8, 16))
def test_running_mean(ref, window):
    """The 1-bit quantizer against the reference's scan (equal) and the
    float64 oracle (bits equal away from the comparison's ties, the final
    average within 1e-5 relative)."""
    data = np.random.default_rng(8).integers(0, 256, size=(192, 6)).astype(
        np.float32)
    ave = RM.running_mean_init_average(torch.from_numpy(data), window)
    assert np.array_equal(ave.numpy(), data[:window].mean(axis=0))
    out, fin = RM.running_mean(torch.from_numpy(data), window, ave)
    assert out.dtype == torch.uint8 and out.shape == data.shape
    assert np.array_equal(out.numpy(), ref[f"running_mean/{window}/out"])
    assert np.array_equal(fin.numpy(), ref[f"running_mean/{window}/ave"])
    o_out, o_fin = RM.running_mean_oracle(data, window, ave.numpy())
    assert np.array_equal(out.numpy(), o_out)
    np.testing.assert_allclose(fin.numpy(), o_fin, rtol=1e-5)


def test_supervisor_budget(ref):
    """``max_restarts`` within ``window_s``, the reference's decisions on
    the same clock; a classifying supervisor (the default) escalates a
    fatal crash at once."""
    got = supervisor_script(Supervisor, 3, 60.0, SUPERVISOR_TIMES)
    for key in ("decisions", "restarts"):
        assert np.array_equal(got[key], ref[f"supervisor/{key}"]), key
    assert got["decisions"].tolist() == [True, True, True, False, False,
                                         True, True, True, True]
    assert not Supervisor("x").should_restart(RuntimeError("crash"))


def test_test_gui_tool(ref, tmp_path):
    """``test_gui`` on the CPU writes the reference tool's files."""
    out = tmp_path / "test_gui"
    assert test_gui.main(gui_tool_argv(out) + ["--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ref["test_gui_files"]


def test_renderer_refuses_tf32_on_the_card(monkeypatch):
    """TF32 would flip colours: the card's resample refuses it (checked
    without a card: the CPU never uses TF32)."""
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    with pytest.raises(ValueError, match="TF32"):
        sp.check_no_tf32(torch.device("cuda"))
    sp.check_no_tf32(torch.device("cpu"))

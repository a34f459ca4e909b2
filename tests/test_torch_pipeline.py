"""The port's ``srtb-torch-main`` against the JAX package's ``srtb-main``:
both search one synthetic 2-bit file of three overlapping segments with a
dispersed pulse in the middle one, with deterministic timestamps and the
waterfall GUI on, and must flag the same segments and write the same
artifacts and waterfall frames."""

import os
import socket

import numpy as np
import pytest
import torch

from srtb_tpu_torch.gui import server as GS
from srtb_tpu_torch.gui import waterfall as GW
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.io.writers import WriteSignalSink
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.tools import main as M
from test_torch_display import assert_pixmaps_match, intensity64, read_png
from test_torch_ref import run_reference
from test_torch_segment import slice_config, stream_bytes

N, CHANNELS, DM = 1 << 16, 32, -0.1


def make_case(tmp, fmt: str = "simple", bits: int = 2):
    """The synthetic file (three overlapping segments, the pulse in the
    middle one, in stream 0 of a multi-stream format) and the CLI
    arguments both packages take for it, less the output prefix."""
    cfg = slice_config(N, CHANNELS, DM).replace(baseband_format_type=fmt,
                                                baseband_input_bits=bits)
    nres = dd.nsamps_reserved(cfg)
    streams = formats.get_data_stream_count(fmt)
    seg = cfg.segment_bytes(streams)
    stride = seg - nres * abs(bits) // 8 * streams
    # segment 1 starts at byte `stride`, sample stride / S * 8 / |bits| of
    # each stream; its searched span is its first N - 2 nres samples: the
    # pulse goes in the middle of that span
    per_byte = 8 // abs(bits)
    pulse_at = stride // streams * per_byte + (N - 2 * nres) // 2
    raw = stream_bytes(cfg, (seg + 2 * stride) // streams * per_byte,
                       pulse_at, 4.0, seed=7)
    data = tmp / "baseband.bin"
    # one byte short of three full segments: the reader emits exactly 3
    raw[: seg + 2 * stride - 1].tofile(data)
    argv = ["--config_file_name", str(tmp / "none.cfg"),
            "--input_file_path", str(data), "--deterministic_timestamps",
            "1", "--gui_enable", "0"]
    for key in ("baseband_input_count", "baseband_input_bits",
                "baseband_format_type", "baseband_freq_low",
                "baseband_bandwidth", "baseband_sample_rate",
                "spectrum_channel_count", "mitigate_rfi_freq_list",
                "mitigate_rfi_average_method_threshold",
                "mitigate_rfi_spectral_kurtosis_threshold",
                "signal_detect_signal_noise_threshold",
                "signal_detect_max_boxcar_length", "fft_strategy"):
        argv += [f"--{key}", str(getattr(cfg, key))]
    argv += ["--dm", f" {DM}", "--use_pallas", "1", "--use_pallas_sk", "1",
             "--baseband_reserve_sample", "1"]
    return argv, nres


def recording_pushes(mp: pytest.MonkeyPatch) -> list:
    """Record every waterfall the port's GUI tap pushes (wf_ri [2, S, F,
    T] float32 and the stream id)."""
    pushed = []
    push = GW.WaterfallService.push

    def recording(self, wf, data_stream_id=0):
        ri = torch.view_as_real(wf).movedim(-1, 0)
        pushed.append((ri.numpy().copy(), data_stream_id))
        return push(self, wf, data_stream_id)
    mp.setattr(GW.WaterfallService, "push", recording)
    return pushed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    argv, nres = make_case(tmp)
    argv += ["--writer_thread_count", "0", "--gui_enable", "1"]
    dirs = {}
    for who in ("port", "ref"):
        dirs[who] = tmp / who
        dirs[who].mkdir()
    ref = run_reference(
        [{"key": "main", "fn": "test_torch_ref:pipeline_main_gui",
          "args": [argv + ["--baseband_output_file_prefix",
                           f"{dirs['ref']}/out_"], str(dirs["ref"])]}],
        tmp)
    with pytest.MonkeyPatch.context() as mp:
        pushed = recording_pushes(mp)
        stats, pipe = M.run(argv + ["--baseband_output_file_prefix",
                                    f"{dirs['port']}/out_", "--device",
                                    "cpu"])
    return {"ref": ref, "stats": stats, "pipe": pipe, "dirs": dirs,
            "nres": nres, "pushed": pushed}


def test_same_segments_and_artifacts(runs):
    """Three segments, only the pulse segment positive in both, and the
    same artifact names (deterministic, offset-derived timestamps)."""
    ref, stats = runs["ref"], runs["stats"]
    assert int(ref["main/rc"]) == 0
    assert stats.segments == 3 and stats.signals == 1
    assert runs["pipe"].positive_segments == [1]
    device_s = stats.extras["device_s_per_segment"]
    stage_s = stats.extras["stage_s"]
    assert len(device_s) == 3 and sum(device_s) == pytest.approx(
        stage_s["dispatch"] + stage_s["overlap"] + stage_s["fetch"])
    port_files = sorted(os.listdir(runs["dirs"]["port"]))
    assert port_files == ref["main/files"].tolist()
    assert sum(name.endswith(".bin") for name in port_files) == 1
    assert any(name.endswith(".1.tim") for name in port_files)


def check_candidate_contents(files, want_npy, want_tim, nres,
                             segment_bytes: int = N * 2 // 8) -> None:
    """One positive segment's files against the reference's arrays
    (``want_npy`` / ``want_tim``: by file name).  .bin: one segment's
    size; .npy (one a stream): the waterfall within 2e-5 of its largest
    value (the segment test's bound); .tim (``.s<stream>.`` in the name
    for a multi-stream format): each boxcar series within b times the
    stream's time-series gates plus two prefix sums' float32 rounding
    (series_b[i] = acc[i + b] - acc[i])."""
    assert os.path.getsize(files.bin_path) == segment_bytes
    gates = []
    for npy in files.npy_paths:
        got_wf = np.load(npy)
        want_wf = want_npy[os.path.basename(npy)]
        assert got_wf.dtype == np.complex64 and got_wf.shape == want_wf.shape
        wf_err = float(np.abs(got_wf - want_wf).max())
        assert wf_err <= 2e-5 * np.abs(want_wf).max()
        t = det.trimmed_length(want_wf.shape[-1], nres // CHANNELS)
        p = np.abs(want_wf[:, :t].astype(np.complex128)) ** 2
        ts_raw = p.sum(0)
        gate = sum(det.time_series_error_gates(CHANNELS, t,
                                               float(ts_raw.max()), wf_err))
        acc_err = 2.0 * t * 2.0 ** -24 * float(
            np.abs(ts_raw - ts_raw.mean()).sum())
        gates.append((gate, acc_err))
    assert files.tim_paths
    for path in files.tim_paths:
        stream, b = os.path.basename(path).rsplit(".", 3)[-3:-1]
        stream = int(stream[1:]) if stream.startswith("s") else 0
        gate, acc_err = gates[stream]
        got = np.fromfile(path, dtype="<f4")
        want = want_tim[os.path.basename(path)]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= int(b) * gate + acc_err


def reference_arrays(ref: dict, key: str, kind: str) -> dict:
    """The ``kind`` ("npy" or "tim") arrays of reference job ``key``, by
    file name."""
    prefix = f"{key}/{kind}/"
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def test_candidate_contents(runs):
    """The positive segment's files against the reference's
    (``check_candidate_contents``), in the port's output directory."""
    ref, dirs = runs["ref"], runs["dirs"]
    sink = runs["pipe"].sink
    assert isinstance(sink, WriteSignalSink) and len(sink.written) == 1
    files = sink.written[0]
    check_candidate_contents(files, reference_arrays(ref, "main", "npy"),
                             reference_arrays(ref, "main", "tim"),
                             runs["nres"])
    assert os.path.dirname(files.npy_paths[0]) == str(dirs["port"])


def test_cli_device_option_and_missing_file(tmp_path, runs):
    argv = ["--input_file_path", str(tmp_path / "missing.bin"), "--device",
            "cpu", "--config_file_name", str(tmp_path / "none.cfg")]
    assert M.main(list(argv)) == 1
    parsed = list(argv)
    assert M._pop_device(parsed) == "cpu" and "--device" not in parsed
    # gui_enable 1: one frame a segment, named and coloured as the
    # reference's (the boundary rule, between the two packages' float64
    # renders of their own waterfalls), candidates as above
    ref, dirs = runs["ref"], runs["dirs"]
    frames = sorted(n for n in os.listdir(dirs["port"])
                    if n.startswith("waterfall_"))
    assert frames == [f"waterfall_s0_{i:06d}.png" for i in range(3)]
    assert frames == [n for n in ref["main/files"].tolist()
                      if n.startswith("waterfall_")]
    pushed = runs["pushed"]
    assert len(pushed) == 3 and int(ref["main/pushed/2/stream"]) == 0
    cfg = runs["pipe"].cfg
    h, w = cfg.gui_pixmap_height, cfg.gui_pixmap_width
    for i, name in enumerate(frames):
        got = read_png(np.fromfile(dirs["port"] / name, dtype=np.uint8))
        want = read_png(ref[f"main/png/{name}"])
        wf_port, stream = pushed[i]
        wf_ref = ref[f"main/pushed/{i}/wf_ri"]
        assert stream == 0 and wf_port.shape == wf_ref.shape
        x_port, x_ref = (intensity64(
            wf[0, 0].astype(np.float64) ** 2
            + wf[1, 0].astype(np.float64) ** 2, h, w)
            for wf in (wf_port, wf_ref))
        assert_pixmaps_match(got, want, x_port, name, x_ref)
        renderer = GW.WaterfallRenderer(*wf_port.shape[2:], h, w,
                                        device="cpu")
        assert np.array_equal(got, renderer.render(torch.complex(
            torch.from_numpy(wf_port[0, 0]),
            torch.from_numpy(wf_port[1, 0]))))


def free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gui_http_port_turns_the_gui_on(tmp_path, monkeypatch):
    """``gui_http_port`` with ``gui_enable 0``: the reference's rule turns
    the GUI on, the viewer serves the frames' directory on that port
    during the run and its thread is joined after it."""
    argv, _nres = make_case(tmp_path)
    servers = []
    init = GS.WaterfallHTTPServer.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        servers.append(self)
    monkeypatch.setattr(GS.WaterfallHTTPServer, "__init__", recording)
    port = free_tcp_port()
    stats, pipe = M.run(argv + [
        "--gui_http_port", str(port), "--writer_thread_count", "0",
        "--baseband_output_file_prefix", f"{tmp_path}/out_",
        "--device", "cpu"])
    assert pipe.cfg.gui_enable and stats.segments == 3
    assert len(servers) == 1 and servers[0].port == port
    assert not servers[0]._thread.is_alive()
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("waterfall_")) == [
        f"waterfall_s0_{i:06d}.png" for i in range(3)]

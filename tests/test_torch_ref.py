"""Reference runner for the port's tests: runs functions of the JAX
package ``srtb_tpu`` in a separate interpreter and hands back numpy arrays.

Why a subprocess: the JAX package does not import under jax 0.9 without a
shim (``srtb_tpu/ops/df64.py:38`` tests ``x not in
batching.primitive_batchers``, which jax 0.9's proxy object no longer
supports).  Applied inside the pytest process, that shim would change
whether the JAX package's own test files pass — and under the tier-1
command every xdist worker collects every file, so the JAX-side count
would depend on the port's test files.  The shim therefore lives only in
this runner's own interpreter, and the pytest process never imports
``srtb_tpu``.

A test module calls :func:`run_reference` once (a module-scoped fixture)
with all its jobs.  Each job names a function as ``"module:function"``
(a ``srtb_tpu`` function, or one defined below), its positional and
keyword arguments (numpy arrays and plain values), and a key; results
come back flattened to ``{"key/field": ndarray}``.  Pallas kernels run
with ``interpret=True``, as the JAX package runs them on the CPU.

Run directly as ``python tests/test_torch_ref.py JOBS.pkl OUT.npz``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run_reference(jobs: list[dict], tmp_dir,
                  compile_cache: bool = False) -> dict[str, np.ndarray]:
    """Run ``jobs`` in one reference interpreter; returns the flattened
    results.  Raises with the runner's output when it fails.
    ``compile_cache`` gives the interpreter a JAX compilation cache under
    ``tmp_dir``, so jobs that build many processors of the same plans
    compile each program once."""
    tmp_dir = Path(tmp_dir)
    req = tmp_dir / "reference_jobs.pkl"
    out = tmp_dir / "reference_out.npz"
    with open(req, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    if compile_cache:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_dir / "jax_cache")
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
        env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, __file__, str(req), str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise RuntimeError("reference runner failed:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------- runner
# (everything below runs only in the runner's interpreter)

def _apply_jax_shim() -> None:
    """Give jax 0.9's PrimitiveBatchersProxy the ``in`` test that
    ``srtb_tpu/ops/df64.py:38`` needs."""
    import jax._src.interpreters.batching as bi
    type(bi.primitive_batchers).__contains__ = \
        lambda self, key: key in bi.fancy_primitive_batchers


def _flatten(key: str, res, out: dict) -> None:
    if res is None:
        return
    if hasattr(res, "_fields"):
        for name in res._fields:
            _flatten(f"{key}/{name}", getattr(res, name), out)
    elif isinstance(res, dict):
        for name, value in res.items():
            _flatten(f"{key}/{name}", value, out)
    elif isinstance(res, (tuple, list)) and not all(
            isinstance(v, (int, float, str, np.generic)) for v in res):
        for i, value in enumerate(res):
            _flatten(f"{key}/{i}", value, out)
    else:
        out[key] = np.asarray(res)


def _resolve(spec: str):
    module, name = spec.split(":")
    if module == "test_torch_ref":
        return globals()[name]
    return getattr(importlib.import_module(module), name)


def config_fields(argv: list) -> dict:
    """The JAX package's Config from a CLI argument list, as JSON."""
    from srtb_tpu.config import Config
    cfg = Config.from_args(list(argv))
    return {"json": json.dumps(dataclasses.asdict(cfg))}


class environ:
    """``os.environ`` updated by ``env`` inside the block, restored after
    it (the reference reads its ``SRTB_*`` switches when a processor is
    built)."""

    def __init__(self, env: dict | None):
        self.env = dict(env or {})

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def segment_process(fields: dict, raw: np.ndarray,
                    window_name: str = "rectangle",
                    staged: bool | None = None, env: dict | None = None,
                    spectrum: bool = False) -> dict:
    """``SegmentProcessor(Config(**fields), window_name, staged=staged)
    .process(raw)`` plus the processor's constants, under the environment
    ``env``; with ``spectrum`` also the staged plan's dedispersed spectrum
    (stage (b)'s output, in natural order)."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.runtime import has_signal
    from srtb_tpu.pipeline.segment import SegmentProcessor
    cfg = Config(**fields)
    with environ(env):
        sp = SegmentProcessor(cfg, window_name=window_name, staged=staged)
        wf_ri, res = sp.process(raw)
        out = {}
        if spectrum:
            spec = np.asarray(sp._run_stage_b(sp._jit_stage_a(
                sp._as_device_bytes(raw))))
            spec = spec.reshape(2, spec.shape[1], -1)
            if sp.front_fuse:
                n1, n2 = sp._ffuse_fac
                spec = np.swapaxes(spec.reshape(2, -1, n1, n2), -1, -2)
            out["spectrum"] = spec.reshape(2, -1, sp.n_spectrum)
    return {
        "fields": json.dumps(dataclasses.asdict(cfg)),
        "wf_ri": wf_ri, "detect": res,
        "has_signal": has_signal(cfg, res,
                                 frequency_bin_count=wf_ri.shape[-2]),
        "has_signal_streams": np.array([
            has_signal(cfg, res, stream=s,
                       frequency_bin_count=wf_ri.shape[-2])
            for s in range(wf_ri.shape[1])]),
        "plan": sp.plan_name, "window": sp.window,
        "dewindow": sp.watfft_dewindow, "rfi_mask": sp.rfi_mask,
        "norm_coeff": sp.norm_coeff, "nsamps_reserved": sp.nsamps_reserved,
        "time_reserved_count": sp.time_reserved_count, **out,
    }


def gate_verdicts(zero_count: np.ndarray, counts: np.ndarray,
                  freq_bins: int, streams: list) -> np.ndarray:
    """The reference's ``has_signal`` at the default config on a detect
    result holding ``zero_count`` and ``counts``, for each entry of
    ``streams`` (None: the segment's verdict)."""
    from types import SimpleNamespace

    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.runtime import has_signal
    res = SimpleNamespace(zero_count=zero_count, signal_counts=counts)
    return np.array([has_signal(Config(), res, stream=s,
                                frequency_bin_count=freq_bins)
                     for s in streams])


def plan_name(fields: dict, env: dict | None = None,
              staged: bool | None = None) -> dict:
    """The plan name of the reference's processor for a config, built
    under the environment ``env``."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.segment import SegmentProcessor
    with environ(env):
        return {"plan": SegmentProcessor(Config(**fields),
                                         staged=staged).plan_name}


def resolved_plan_name(fields: dict, env: dict | None = None,
                       staged: bool | None = None) -> dict:
    """The reference's plan name for a config, composed as its
    ``SegmentProcessor.plan_name`` composes it, from its module-level
    resolutions (no processor is built, so a 2^30 config costs nothing
    here): the staged flag and strategy, the fused tail, the front fuse,
    the skzap rule and the ingest ring."""
    from srtb_tpu.config import Config
    from srtb_tpu.ops import fft as F
    from srtb_tpu.ops import pallas_fft as pf
    from srtb_tpu.pipeline import segment as S
    cfg = Config(**fields)
    n = cfg.baseband_input_count
    staged = S.staged_resolves(cfg, staged)
    channels = min(cfg.spectrum_channel_count, n // 2)
    with environ(env):
        tail = S.fused_tail_resolves(cfg, staged)
        name = ("staged" if staged else "fused") + ":" \
            + F.resolve_strategy(n, cfg.fft_strategy)
        if tail:
            name += "+ftail"
        if S.front_fuse_resolves(cfg, staged):
            name += "+ffuse"
        if (tail and cfg.use_pallas and cfg.use_pallas_sk
                and pf.supported(n // 2 // channels, channels)):
            name += "+skzap"
        if str(cfg.ingest_ring).lower() != "off" and S.ring_usable(cfg):
            name += "+ring"
    return {"plan": name, "streams": S.formats.resolve(
        cfg.baseband_format_type).data_stream_count}


def plan_resolution(fields: dict, env: dict | None = None) -> dict:
    """The reference's plan flags for a config under the environment
    ``env``, without building a processor: staged, the resolved strategy,
    the fused tail and the front fuse (or the name of the exception a
    resolution raises), and the plan's ``hbm_passes`` (-1 when a
    resolution raises)."""
    from srtb_tpu.config import Config
    from srtb_tpu.ops import fft as F
    from srtb_tpu.ops import pallas_fft as pf
    from srtb_tpu.pipeline import segment as S
    cfg = Config(**fields)
    staged = S.staged_resolves(cfg)
    out = {"staged": staged,
           "strategy": F.resolve_strategy(cfg.baseband_input_count,
                                          cfg.fft_strategy)}
    with environ(env):
        for key, resolve in (("fused_tail", S.fused_tail_resolves),
                             ("front_fuse", S.front_fuse_resolves)):
            try:
                out[key] = str(resolve(cfg, staged))
            except ValueError:
                out[key] = "ValueError"
    out["hbm_passes"] = -1
    if "ValueError" not in (out["fused_tail"], out["front_fuse"]):
        n = cfg.baseband_input_count
        channels = min(cfg.spectrum_channel_count, n // 2)
        tail = out["fused_tail"] == "True"
        skzap = bool(tail and cfg.use_pallas and cfg.use_pallas_sk
                     and pf.supported(n // 2 // channels, channels))
        out["hbm_passes"] = int(ref_hbm_passes(
            [(tail, skzap, out["front_fuse"] == "True")])["passes"][0])
    return out


def pass1_front(raw: np.ndarray, m: int, variant: str, nbits: int,
                window_eo=None, inverse: bool = False) -> dict:
    """``pallas_fft2.pass1_front`` in interpret mode, with its
    ``front_mean_power``: the intermediate (re, im), the accumulators and
    the mean."""
    import jax.numpy as jnp
    from srtb_tpu.io import formats
    from srtb_tpu.ops import pallas_fft2 as pf2
    streams = 2 if variant == "interleaved_samples_2" else 1
    assert formats.resolve(variant).data_stream_count == streams
    w = None if window_eo is None else tuple(jnp.asarray(a)
                                             for a in window_eo)
    br, bi, aux = pf2.pass1_front(jnp.asarray(raw), m=m, streams=streams,
                                  variant=variant, nbits=nbits, window_eo=w,
                                  inverse=inverse, interpret=True)
    n2 = pf2.ffuse_factor(m)[1]
    return {"br": br, "bi": bi, "aux": aux,
            "mean": pf2.front_mean_power(aux, n2, m)}


def pass2_spectrum(br: np.ndarray, bi: np.ndarray, thr: float, norm: float,
                   mask_blocked=None, premul_blocked=None,
                   chirp=None) -> dict:
    """``pallas_fft2.pass2_spectrum`` in interpret mode."""
    import jax.numpy as jnp
    from srtb_tpu.ops import pallas_fft2 as pf2
    pm = None if premul_blocked is None else tuple(
        jnp.asarray(a) for a in premul_blocked)
    sr, si = pf2.pass2_spectrum(
        jnp.asarray(br), jnp.asarray(bi), thr=jnp.float32(thr), norm=norm,
        mask_blocked=None if mask_blocked is None
        else jnp.asarray(mask_blocked), premul_blocked=pm, chirp=chirp,
        interpret=True)
    return {"sr": sr, "si": si}


def format_registry(names: list) -> dict:
    """``formats.resolve`` of each name (its fields, the payload bytes and
    ``get_data_stream_count``), or the message of the ``ValueError`` it
    raises."""
    from srtb_tpu.io import formats
    out = {}
    for name in names:
        try:
            f = formats.resolve(name)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        out[name] = {
            "name": f.name, "data_stream_count": f.data_stream_count,
            "packet_header_size": f.packet_header_size,
            "packet_payload_size": f.packet_payload_size,
            "payload_bytes": f.payload_bytes,
            "unpack_variant": f.unpack_variant,
            "parser": "" if f.parse_packet is None
            else f.parse_packet.__name__,
            "streams": formats.get_data_stream_count(name)}
    return out


def parse_packets(packets: list) -> dict:
    """``parse_vdif_header`` and both counter parsers on each packet."""
    from srtb_tpu.io import formats
    return {str(i): {"vdif": formats.parse_vdif_header(p),
                     "le64": formats._parse_counter_le64(p),
                     "vdif_counter": formats._parse_counter_vdif(p)}
            for i, p in enumerate(packets)}


def unpack_call(name: str, data: np.ndarray, nbits=None,
                window=None, variant=None) -> dict:
    """An unpack function of the JAX package (``ops.unpack.<name>``, or
    ``pipeline.segment.unpack_streams`` for ``name == "unpack_streams"``)
    on ``data``, eagerly and under ``jax.jit`` (the pipeline runs it
    inside its jitted programs); ``window`` is passed by keyword."""
    import jax
    import jax.numpy as jnp
    if name == "unpack_streams":
        from srtb_tpu.pipeline.segment import unpack_streams

        def fn(d, window):
            return unpack_streams(d, variant, nbits, window)
    else:
        from srtb_tpu.ops import unpack as U
        args = () if nbits is None else (nbits,)

        def fn(d, window):
            return getattr(U, name)(d, *args, window=window)
    w = None if window is None else jnp.asarray(window)
    d = jnp.asarray(data)
    return {"eager": fn(d, w), "jit": jax.jit(fn)(d, w)}


def pipeline_main(argv: list, out_dir: str) -> dict:
    """``srtb-main`` on ``argv``; returns its exit code, the artifact
    names under ``out_dir`` and the content of every ``.tim`` and
    ``.npy`` artifact."""
    from srtb_tpu.tools.main import main
    rc = main(list(argv))
    names = sorted(os.listdir(out_dir))
    res = {"rc": rc, "files": np.array(names)}
    for name in names:
        path = os.path.join(out_dir, name)
        if name.endswith(".tim"):
            res[f"tim/{name}"] = np.fromfile(path, dtype="<f4")
        elif name.endswith(".npy"):
            res[f"npy/{name}"] = np.load(path)
        elif name.endswith((".png", ".json")):
            res[f"{name.rsplit('.', 1)[1]}/{name}"] = np.fromfile(
                path, dtype=np.uint8)
    return res


def pipeline_main_gui(argv: list, out_dir: str) -> dict:
    """:func:`pipeline_main` with every waterfall the GUI tap pushes
    recorded (``pushed/<i>``: wf_ri [2, S, F, T] and its stream id)."""
    from srtb_tpu.gui.waterfall import WaterfallService
    pushed = []
    push = WaterfallService.push

    def recording(self, wf_ri, data_stream_id=0):
        pushed.append({"wf_ri": np.asarray(wf_ri),
                       "stream": data_stream_id})
        return push(self, wf_ri, data_stream_id)
    WaterfallService.push = recording
    try:
        res = pipeline_main(argv, out_dir)
    finally:
        WaterfallService.push = push
    res["pushed"] = pushed
    return res


# ------------------------------------------------------------ display
# The JAX package's waterfall, viewer and display tools, for
# tests/test_torch_display.py.

def render_waterfall(wf_ri: np.ndarray, out_h: int, out_w: int) -> dict:
    """``WaterfallRenderer(F, T, out_h, out_w).render`` of one stream's
    ``wf_ri [2, F, T]``, with the float intensity the colormap reads
    (its ``_render_impl`` before ``generate_pixmap``)."""
    import jax.numpy as jnp
    from srtb_tpu.gui.waterfall import WaterfallRenderer
    from srtb_tpu.ops import spectrum as sp
    r = WaterfallRenderer(wf_ri.shape[1], wf_ri.shape[2], out_h, out_w)
    x = jnp.asarray(wf_ri)
    power = x[0] ** 2 + x[1] ** 2
    img = sp.normalize_by_average(
        sp.resample_spectrum(power, r.w_freq, r.w_time))
    return {"pixmap": r.render(wf_ri), "intensity": img}


def png_bytes(argb: np.ndarray, path: str) -> dict:
    """``write_png`` of ``argb`` to ``path``; the file's bytes."""
    from srtb_tpu.gui.waterfall import write_png
    write_png(path, argb)
    return {"bytes": np.fromfile(path, dtype=np.uint8)}


def scroll_script(scroller_cls, in_freq: int, width: int, height: int,
                  script: list) -> dict:
    """A ``ScrollingWaterfall`` of ``scroller_cls`` driven by ``script``:
    ("push", power [in_freq]) or ("consume", None) steps.  Returns the
    request size before each step, each consume's count, ``lines_total``
    after each step and the final render."""
    sw = scroller_cls(in_freq, width, height)
    sizes, taken, totals = [], [], []
    for op, arg in script:
        sizes.append(sw.scheduler.get_next_request_size())
        if op == "push":
            sw.push_spectrum(arg)
        else:
            taken.append(sw.consume())
        totals.append(sw.lines_total)
    return {"sizes": np.array(sizes), "taken": np.array(taken),
            "totals": np.array(totals), "render": sw.render()}


def ref_scroll_script(*args) -> dict:
    """:func:`scroll_script` on the JAX package's scroller."""
    from srtb_tpu.gui.waterfall import ScrollingWaterfall
    return scroll_script(ScrollingWaterfall, *args)


def ref_waterfall_service(fields: dict, in_freq: int, in_time: int,
                          pushes: list, out_dir: str) -> dict:
    """The JAX package's ``WaterfallService`` on ``Config(**fields)``: each
    (wf_ri [2, S, F, T], stream) pushed and ``render_pending`` called;
    returns the paths returned and every file under ``out_dir`` with its
    bytes."""
    from srtb_tpu.config import Config
    from srtb_tpu.gui.waterfall import WaterfallService
    svc = WaterfallService(Config(**fields), in_freq, in_time,
                           out_dir=out_dir)
    returned = []
    for wf_ri, stream in pushes:
        svc.push(wf_ri, stream)
        returned.append(os.path.basename(svc.render_pending() or ""))
    names = sorted(os.listdir(out_dir))
    res = {"returned": np.array(returned), "files": np.array(names)}
    for name in names:
        res[f"png/{name}"] = np.fromfile(os.path.join(out_dir, name),
                                         dtype=np.uint8)
    return res


VIEWER_TIMEOUT_S = 10.0


def viewer_responses(server_cls, directory: str, paths: list,
                     **kwargs) -> dict:
    """``server_cls(directory, port=0, **kwargs)`` started on an OS-chosen
    port, one GET of each path (each bounded at ``VIEWER_TIMEOUT_S``), then
    stopped: each response's status, content type and body, and whether
    the serve thread ended."""
    import urllib.error
    import urllib.request
    server = server_cls(directory, port=0, **kwargs).start()
    res = {}
    try:
        for i, path in enumerate(paths):
            url = f"http://127.0.0.1:{server.port}{path}"
            try:
                with urllib.request.urlopen(
                        url, timeout=VIEWER_TIMEOUT_S) as r:
                    code, ctype, body = r.status, r.headers.get(
                        "Content-Type", ""), r.read()
            except urllib.error.HTTPError as e:
                code, ctype, body = e.code, e.headers.get(
                    "Content-Type", "") or "", e.read()
            res[str(i)] = {"status": code, "type": ctype,
                           "body": np.frombuffer(body, dtype=np.uint8)}
    finally:
        server.stop()
    res["thread_ended"] = not server._thread.is_alive()
    return res


def ref_viewer_responses(directory: str, paths: list) -> dict:
    """:func:`viewer_responses` on the JAX package's server."""
    from srtb_tpu.gui.server import WaterfallHTTPServer
    return viewer_responses(WaterfallHTTPServer, directory, paths)


class block_matplotlib:
    """``import matplotlib`` raises ImportError inside the block."""

    def __enter__(self):
        self.saved = {k: sys.modules[k] for k in list(sys.modules)
                      if k == "matplotlib" or k.startswith("matplotlib.")}
        for k in self.saved:
            del sys.modules[k]
        sys.modules["matplotlib"] = None

    def __exit__(self, *exc):
        del sys.modules["matplotlib"]
        sys.modules.update(self.saved)


def ref_plot_spectrum_fallback(path: str) -> dict:
    """The JAX package's ``plot_spectrum.plot_one`` with matplotlib
    blocked: the PNG it writes, by bytes."""
    from srtb_tpu.tools.plot_spectrum import plot_one
    with block_matplotlib():
        out = plot_one(path)
    return {"name": os.path.basename(out),
            "bytes": np.fromfile(out, dtype=np.uint8)}


def run_printing(main, argv: list, matplotlib: bool) -> dict:
    """``main(argv)`` with its standard output captured, matplotlib
    blocked unless ``matplotlib``: the exit code and the text."""
    import contextlib
    import io
    buf = io.StringIO()
    block = contextlib.nullcontext() if matplotlib else block_matplotlib()
    with block, contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return {"rc": rc, "stdout": buf.getvalue()}


def ref_plot_tim(argv: list, matplotlib: bool) -> dict:
    """:func:`run_printing` of the JAX package's ``plot_tim.main``."""
    from srtb_tpu.tools.plot_tim import main
    return run_printing(main, argv, matplotlib)


def ref_make_baseband(argv: list) -> dict:
    """``srtb-make-baseband`` on ``argv`` (its ``--out`` file's bytes)."""
    from srtb_tpu.tools.make_baseband import main
    rc = main(list(argv))
    out = argv[argv.index("--out") + 1]
    return {"rc": rc, "bytes": np.fromfile(out, dtype=np.uint8)}


def ref_running_mean(data: np.ndarray, windowsize: int,
                     ave: np.ndarray) -> dict:
    """The JAX package's ``running_mean`` on device arrays (its scan
    indexes them with traced indices)."""
    import jax.numpy as jnp
    from srtb_tpu.ops.running_mean import running_mean
    out, fin = running_mean(jnp.asarray(data), windowsize, jnp.asarray(ave))
    return {"out": out, "ave": fin}


def supervisor_script(supervisor_cls, max_restarts: int, window_s: float,
                      times: list) -> dict:
    """A ``restart_fatal`` supervisor of ``supervisor_cls`` on a clock
    that reads ``times`` in turn: ``should_restart`` at each time (one
    clock read each), then the restarts inside the window."""
    clock_values = []

    def clock():
        return clock_values.pop(0)
    sup = supervisor_cls("test", max_restarts=max_restarts,
                         window_s=window_s, restart_fatal=True, clock=clock)
    decisions = []
    for t in times:
        clock_values.append(t)
        decisions.append(sup.should_restart(RuntimeError("crash")))
    return {"decisions": np.array(decisions), "restarts": sup.restarts}


def ref_supervisor_script(*args) -> dict:
    """:func:`supervisor_script` on the JAX package's supervisor."""
    from srtb_tpu.resilience.supervisor import Supervisor
    return supervisor_script(Supervisor, *args)


def quality_monitor_script(fields: dict, vectors: list) -> dict:
    """The JAX package's ``QualityMonitor.from_config`` observing each
    vector in turn: the dicts, as JSON, and the timeline."""
    from srtb_tpu.config import Config
    from srtb_tpu.quality.stats import QualityMonitor
    mon = QualityMonitor.from_config(Config(**fields))
    outs = [mon.observe(v, segment=i) for i, v in enumerate(vectors)]
    return {"json": json.dumps(outs),
            "timeline": json.dumps(mon.timeline())}


# ------------------------------------------------------------ UDP harness
# Plain socket and numpy code shared by the port's UDP tests and the
# runner's UDP jobs: the same packets, made from a seed, go to the port's
# receivers in the test process and to the JAX package's in the runner,
# each from its own sender thread.  Every wait is bounded: a lost
# datagram fails its test within UDP_TIMEOUT_S instead of hanging.

UDP_TIMEOUT_S = 30.0


def free_udp_port() -> int:
    """A UDP port the OS picks (bound once, then released)."""
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_datagram(fmt_name: str, counter: int, payload: bytes) -> bytes:
    """One packet of ``fmt_name``: its header with ``counter`` (LE64 at
    offset 0, or VDIF words 6 and 7 of a 64-byte header for the gznupsr
    formats), then the payload."""
    import struct
    if fmt_name.startswith("gznupsr"):
        header = bytearray(64)
        struct.pack_into("<2I", header, 24, counter & 0xFFFFFFFF,
                         counter >> 32)
        return bytes(header) + payload
    return struct.pack("<Q", counter) + payload


def seeded_payload(seed: int, counter: int, size: int) -> bytes:
    """The payload of the packet with ``counter``: a duplicate of a
    counter carries the same bytes."""
    rng = np.random.default_rng([seed, counter])
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def send_datagrams(port: int, datagrams, delay: float = 0.0,
                   start_delay: float = 0.1) -> None:
    import socket
    import time
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    time.sleep(start_delay)  # let the receiver bind
    for d in datagrams:
        sock.sendto(d, ("127.0.0.1", port))
        if delay:
            time.sleep(delay)
    sock.close()


def start_thread(fn, *args):
    import threading
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def bounded(fn, what: str, timeout: float = UDP_TIMEOUT_S):
    """``fn()`` on a daemon thread: its result, its exception re-raised,
    or TimeoutError after ``timeout`` seconds (the thread is left
    blocked; it dies with the process)."""
    import threading
    box = {}

    def body():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"{what}: no result within {timeout:g} s "
                           "(a datagram lost on loopback?)")
    if "error" in box:
        raise box["error"]
    return box["value"]


def receive_blocks(udp, kind: str, fmt_name: str, counters: list,
                   seed: int, block_bytes: list) -> dict:
    """One receiver of ``kind`` ("native", "python", "asyncio",
    "continuous", "ring") of the module ``udp`` on a free port: the
    packets of ``counters`` sent in that order, then one
    ``receive_block`` a size of ``block_bytes``, each into a buffer
    prefilled with 0xA5 (a receiver zeroes lost slots itself).  Returns
    the blocks, their (first, lost, total) and the receiver's totals, or
    ``skipped`` with the reason when the receiver cannot be made here."""
    fmt = udp.formats.resolve(fmt_name)
    port = free_udp_port()
    makers = {"native": udp.NativeBlockReceiver,
              "python": udp.PythonBlockReceiver,
              "asyncio": udp.AsyncioBlockReceiver,
              "continuous": udp.PythonContinuousReceiver}
    try:
        if kind == "ring":
            rx = udp.PacketRingReceiver("", port, fmt, interface="lo")
        else:
            rx = makers[kind]("127.0.0.1", port, fmt)
    except (OSError, RuntimeError) as e:
        return {"skipped": f"{type(e).__name__}: {e}"}
    datagrams = [make_datagram(fmt_name, c,
                               seeded_payload(seed, c, fmt.payload_bytes))
                 for c in counters]
    sender = start_thread(send_datagrams, port, datagrams)
    blocks, stamps = [], []
    for nbytes in block_bytes:
        out = np.full(nbytes, 0xA5, dtype=np.uint8)
        stamps.append(bounded(lambda: rx.receive_block(out),
                              f"{kind} receive_block"))
        blocks.append(out)
    sender.join(UDP_TIMEOUT_S)
    res = {"blocks": blocks, "stamps": np.array(stamps, dtype=np.int64),
           "total_packets": rx.total_packets,
           "lost_packets": rx.lost_packets}
    rx.close()
    return res


def source_segments(udp, cfg, counters_by_port: list, seed: int,
                    segments: int, use_native=None,
                    delay: float = 0.0) -> dict:
    """``UdpReceiverSource`` (one entry in ``counters_by_port``) or
    ``MultiUdpSource`` (several) of the module ``udp`` on ``cfg`` with
    the receivers on free loopback ports, each port sent its counters'
    packets (payloads seeded by ``seed`` and the port's index); returns
    ``segments`` segments a port: their bytes, packet counters and seqs,
    and the source's geometry and receivers' loss totals."""
    import dataclasses
    ports = [free_udp_port() for _ in counters_by_port]
    cfg = dataclasses.replace(cfg, udp_receiver_address=["127.0.0.1"],
                              udp_receiver_port=ports)
    fmt = udp.formats.resolve(cfg.baseband_format_type)
    multi = len(ports) > 1
    src = (udp.MultiUdpSource(cfg, use_native=use_native) if multi
           else udp.UdpReceiverSource(cfg, use_native=use_native))
    senders = [start_thread(
        send_datagrams, port,
        [make_datagram(fmt.name, c, seeded_payload(seed + i, c,
                                                   fmt.payload_bytes))
         for c in counters], delay)
        for i, (port, counters) in enumerate(zip(ports, counters_by_port))]
    got = {i: [] for i in range(len(ports))}
    while min(len(v) for v in got.values()) < segments:
        seg = bounded(lambda: next(src), "source segment")
        got[seg.data_stream_id].append(seg)
    for t in senders:
        t.join(UDP_TIMEOUT_S)
    res = {}
    for i, segs in got.items():
        segs = segs[:segments]
        res[str(i)] = {
            "data": np.stack([np.array(s.data) for s in segs]),
            "counter": np.array([s.udp_packet_counter for s in segs],
                                dtype=np.uint64),
            "seq": np.array([s.seq for s in segs])}
    sources = src.sources if multi else [src]
    res["reserved_bytes"] = sources[0].reserved_bytes
    res["stride_bytes"] = sources[0].stride_bytes
    res["total_packets"] = [s.receiver.total_packets for s in sources]
    res["lost_packets"] = [s.receiver.lost_packets for s in sources]
    src.close()
    return res


def stream_datagrams(fmt_name: str, payload: int, stream: np.ndarray,
                     counter0: int) -> list:
    """A contiguous byte stream as counter-sequential packets from
    ``counter0``."""
    return [make_datagram(fmt_name, counter0 + i,
                          stream[i * payload:(i + 1) * payload].tobytes())
            for i in range(len(stream) // payload)]


def paced_pipeline(udp, pipeline_cls, cfg, stream: np.ndarray,
                   segments: int, pace_s: float, out_dir: str,
                   counter0: int = 1000, **pipeline_kwargs) -> dict:
    """``pipeline_cls(cfg, source=UdpReceiverSource(cfg))`` of the module
    ``udp`` on a free loopback port, fed ``stream`` (at least
    ``segments`` segments' bytes, overlap included) as counter-sequential
    packets: the first segment's packets at once, then each stride's
    ``pace_s`` seconds after the source returned the previous segment, so
    that no two segments' arrival stamps lie within the piggyback's
    window.  ``run(max_segments=segments)``; returns each segment's
    counter and decision, and the files written under ``out_dir`` with
    their bytes."""
    import dataclasses
    import os
    import threading
    import time
    port = free_udp_port()
    cfg = dataclasses.replace(cfg, udp_receiver_address=["127.0.0.1"],
                              udp_receiver_port=[port])
    returned = threading.Semaphore(0)

    class Paced(udp.UdpReceiverSource):
        def __next__(self):
            seg = super().__next__()
            returned.release()
            return seg

    src = Paced(cfg)
    fmt = src.fmt
    payload = fmt.payload_bytes
    datagrams = stream_datagrams(fmt.name, payload, stream, counter0)
    first = src.segment_bytes // payload
    stride = src.stride_bytes // payload

    def send():
        send_datagrams(port, datagrams[:first])
        for k in range(1, segments):
            if not returned.acquire(timeout=UDP_TIMEOUT_S):
                return
            time.sleep(pace_s)
            lo = first + (k - 1) * stride
            send_datagrams(port, datagrams[lo:lo + stride], start_delay=0)

    pipe = pipeline_cls(cfg, source=src, **pipeline_kwargs)
    decisions = []

    class Tap:
        def push(self, work, has_signal):
            decisions.append((int(work.segment.udp_packet_counter),
                              bool(has_signal)))
    pipe.sinks.append(Tap())
    sender = start_thread(send)
    try:
        bounded(lambda: pipe.run(max_segments=segments), "paced pipeline",
                timeout=4 * UDP_TIMEOUT_S)
        lost = src.receiver.lost_packets
        native = type(src.receiver).__name__ == "NativeBlockReceiver"
    finally:
        pipe.close()
    sender.join(UDP_TIMEOUT_S)
    names = sorted(os.listdir(out_dir))
    res = {"decisions": np.array(decisions, dtype=np.uint64),
           "files": np.array(names), "reserved_bytes": src.reserved_bytes,
           "lost_packets": lost, "native": native}
    for name in names:
        path = os.path.join(out_dir, name)
        if name.endswith(".tim"):
            res[f"tim/{name}"] = np.fromfile(path, dtype="<f4")
        elif name.endswith(".npy"):
            res[f"npy/{name}"] = np.load(path)
        elif name.endswith(".bin"):
            res[f"bin/{name}"] = np.fromfile(path, dtype=np.uint8)
    return res


def ref_receive_blocks(*args) -> dict:
    """:func:`receive_blocks` on the JAX package's receivers."""
    from srtb_tpu.io import udp
    return receive_blocks(udp, *args)


def ref_source_segments(fields: dict, *args, **kwargs) -> dict:
    """:func:`source_segments` on the JAX package's sources."""
    from srtb_tpu.config import Config
    from srtb_tpu.io import udp
    return source_segments(udp, Config(**fields), *args, **kwargs)


def ref_source_refusals(fields: dict, cases: list) -> dict:
    """For each (overrides, use_native): the ValueError text the JAX
    package's ``UdpReceiverSource`` raises on ``Config(**fields)`` with
    the overrides, or "" when it builds."""
    from srtb_tpu.config import Config
    from srtb_tpu.io import udp
    out = {}
    for i, (over, use_native) in enumerate(cases):
        try:
            udp.UdpReceiverSource(Config(**{**fields, **over}),
                                  use_native=use_native).close()
            out[str(i)] = ""
        except ValueError as e:
            out[str(i)] = str(e)
    return out


def ref_paced_pipeline(fields: dict, stream: np.ndarray, segments: int,
                       pace_s: float, out_dir: str) -> dict:
    """:func:`paced_pipeline` on the JAX package's source and
    ``Pipeline``."""
    from srtb_tpu.config import Config
    from srtb_tpu.io import udp
    from srtb_tpu.pipeline.runtime import Pipeline
    return paced_pipeline(udp, Pipeline, Config(**fields), stream, segments,
                          pace_s, out_dir)


def ref_write_signal_script(fields: dict, script: list, segment_bytes: int,
                            out_dir: str) -> dict:
    """The JAX package's ``WriteSignalSink`` fed the scripted pushes
    (:func:`scripted_pushes`); returns the files it wrote and their
    bytes, and the sink's queues after each push."""
    from srtb_tpu.config import Config
    from srtb_tpu.io.writers import WriteSignalSink
    from srtb_tpu.pipeline.work import SegmentResultWork, SegmentWork
    return scripted_pushes(WriteSignalSink(Config(**fields)),
                           SegmentResultWork, SegmentWork, script,
                           segment_bytes, out_dir)


def scripted_pushes(sink, result_cls, segment_cls, script: list,
                    segment_bytes: int, out_dir: str) -> dict:
    """Push ``script``'s (timestamp, has_signal, stream) segments into a
    candidate writer with real-time input: segment i's bytes are i + 1
    repeated and its packet counter is 100 + i, with no waterfall and no
    detection (the writer's capture policy alone).  Returns the files
    written, by name with their bytes, and the positive and negative
    queue lengths after each push."""
    import os
    queues = []
    for i, (ts, positive, stream) in enumerate(script):
        seg = segment_cls(data=np.full(segment_bytes, i + 1, np.uint8),
                          timestamp=int(ts), udp_packet_counter=100 + i,
                          data_stream_id=int(stream))
        sink.push(result_cls(segment=seg), bool(positive))
        queues.append((len(sink.recent_positive_timestamps),
                       len(sink.recent_negative_works)))
    names = sorted(os.listdir(out_dir))
    res = {"files": np.array(names), "queues": np.array(queues)}
    for name in names:
        res[f"bin/{name}"] = np.fromfile(os.path.join(out_dir, name),
                                         dtype=np.uint8)
    return res


def ref_main_source(argv: list) -> dict:
    """The input ``srtb-main`` selects for ``argv`` (the pipeline replaced
    by a stub that records its source's class): its exit code and the
    class name ("" for a run that built no pipeline, "file" for the
    pipeline's own file reader)."""
    from srtb_tpu.pipeline.runtime import PipelineStats
    from srtb_tpu.tools import main as M
    chosen = []

    class Stub:
        def __init__(self, cfg, source=None, sinks=None, **_kw):
            chosen.append("file" if source is None
                          else type(source).__name__)
            self.source, self.sinks = source, []

        def run(self):
            return PipelineStats()

        def close(self):
            if self.source is not None:
                self.source.close()
    M.Pipeline = Stub
    rc = M.main(list(argv))
    return {"rc": rc, "source": chosen[0] if chosen else ""}


def segment_batch(fields: dict, raws: np.ndarray, news: np.ndarray, window_name: str = "rectangle",
                  env: dict | None = None) -> dict:
    """The reference's micro-batch steps on one processor: its plan,
    ``process_batch(raws)``, ``process_batch_cold(raws)`` (with the next
    carry) and ``process_batch_ring(carry, news)`` from the cold step's
    carry (with its next carry)."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.segment import SegmentProcessor
    with environ(env):
        sp = SegmentProcessor(Config(**fields), window_name=window_name)
        wf, det = sp.process_batch(raws)
        out = {"plan": sp.plan_name, "batch": {"wf_ri": wf, "detect": det}}
        (wf, det), carry = sp.process_batch_cold(raws)
        # fetched before the ring step consumes (donates) the carry
        out["cold"] = {"wf_ri": np.asarray(wf), "detect": det,
                       "carry": np.asarray(carry)}
        (wf, det), carry = sp.process_batch_ring(carry, news)
        out["ring"] = {"wf_ri": wf, "detect": det, "carry": carry}
    return out


def manifest_records(records: list) -> dict:
    """The reference's ``record_crc`` and ``encode_record`` of each
    record."""
    from srtb_tpu.io import manifest as M
    return {"crc": np.array([M.record_crc(r) for r in records],
                            dtype=np.int64),
            "encoded": np.array([M.encode_record(r).decode()
                                 for r in records])}


def recover_dir(manifest_path: str, hint: int = 0) -> dict:
    """The reference's ``recover`` on a run directory, applied: its
    report (paths relative to the manifest's directory) and every file
    left in the directory with its bytes."""
    from srtb_tpu.io import manifest as M
    rep = M.recover(manifest_path, apply=True, checkpoint_floor_hint=hint)
    d = os.path.dirname(manifest_path)
    return {"report": json.dumps(report_fields(rep, d)),
            "files": json.dumps(dir_bytes(d))}


def report_fields(rep, d: str) -> dict:
    """A RecoveryReport as plain JSON, the directory ``d`` cut from its
    paths (so two copies of one run directory compare)."""
    def rel(text):
        return str(text).replace(d + os.sep, "")
    return {"done": sorted(list(k) for k in rep.done),
            "last_checkpoint": rep.last_checkpoint,
            "truncated_bytes": rep.truncated_bytes,
            "rolled_back": [rel(a) for a in rep.rolled_back],
            "rolled_back_intents": rep.rolled_back_intents,
            "missing": [rel(m) for m in rep.missing],
            "recovered_segments": rep.recovered_segments}


def dir_bytes(d: str) -> dict:
    """name -> hex bytes of every file in ``d``."""
    return {name: open(os.path.join(d, name), "rb").read().hex()
            for name in sorted(os.listdir(d))}


def fsck_dir(manifest_path: str, checkpoint_path: str) -> dict:
    """The reference's ``fsck`` report of a run directory."""
    from srtb_tpu.tools.fsck import fsck
    return {"report": json.dumps(fsck(manifest_path, checkpoint_path))}


def periodicity_ops(series: list, harmonics: int, top_k: int,
                    n_bins: int, min_bin: int) -> dict:
    """The JAX package's periodicity ops on each series: the power
    spectrum, the harmonic sums, the candidate search, the folds at its
    bins and the whole search (jitted, as the processor traces it)."""
    import jax
    import jax.numpy as jnp
    from srtb_tpu.ops import periodicity as P
    levels = P.harmonic_levels(harmonics)
    out = {"levels": np.asarray(levels)}
    for i, ts in enumerate(series):
        x = jnp.asarray(ts)
        bins, snr, harm = P.candidate_search(x, levels, top_k,
                                             min_bin=min_bin)
        search = jax.jit(lambda v: P.periodicity_search(
            v, harmonics, top_k, n_bins, min_bin=min_bin))(x)
        out[str(i)] = {
            "power": P.power_spectrum(x),
            "sums": P.harmonic_sum(P.power_spectrum(x), levels),
            "bins": bins, "snr": snr, "harmonics": harm,
            "folds": jnp.stack([P.fold(x, b, n_bins) for b in bins]),
            "search": search}
    return out


def fold_guard(lengths: list, n_bins: int) -> dict:
    """For each series length, whether the JAX package's ``fold`` refuses
    it (its uint32 phase guard) and the message."""
    import jax.numpy as jnp
    from srtb_tpu.ops import periodicity as P
    out = []
    for t in lengths:
        try:
            P.fold(jnp.zeros(t, jnp.float32), jnp.int32(1), n_bins)
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return {"messages": np.array(out)}


def periodicity_processor(fields: dict, raws: list,
                          staged: bool | None = None,
                          batch: bool = False) -> dict:
    """The reference's ``registry.build_processor`` on ``fields`` (the
    periodicity mode): its plan, and per segment of ``raws`` the result,
    the gate's verdicts (the segment's and each stream's), the journal
    payload and the extra artifacts (path suffix and bytes); with
    ``batch``, ``process_batch`` of all of them (lane i of each field)."""
    from srtb_tpu.config import Config
    from srtb_tpu.io.writers import _npy_bytes
    from srtb_tpu.pipeline import registry
    from srtb_tpu.pipeline.runtime import has_signal
    cfg = Config(**fields)
    kwargs = {} if staged is None else {"staged": staged}
    sp = registry.build_processor(cfg, **kwargs)
    out = {"plan": sp.plan_name}
    if batch:
        wf, det = sp.process_batch(np.stack(raws))
        out["batch"] = det
        return out
    for i, raw in enumerate(raws):
        wf, det = sp.process(raw)
        det = type(det)(*[np.asarray(v) if hasattr(v, "shape") else v
                          for v in det])
        streams = det.zero_count.shape[0]
        arts = {}
        for path, payload in det.extra_artifacts("BASE"):
            if path.endswith(".npy"):
                payload = _npy_bytes(payload)
            arts[path] = np.asarray(payload, dtype=np.uint8)
        out[str(i)] = {
            "detect": det, "wf_ri": wf,
            "has_signal": has_signal(cfg, det,
                                     frequency_bin_count=wf.shape[-2]),
            "by_stream": np.array([has_signal(
                cfg, det, stream=s, frequency_bin_count=wf.shape[-2])
                for s in range(streams)]),
            "gate": np.asarray(det.positive_gate(cfg)),
            "span": json.dumps(det.span_extra()),
            "artifacts": json.dumps({k: v.tobytes().hex()
                                     for k, v in arts.items()})}
    return out


def periodicity_gate_cases(cases: list) -> dict:
    """``has_signal`` of the reference's ``PeriodicityResult`` built as
    its tests build one (no boxcar hit, the given candidate scores and
    trial counts), at each case's ``periodicity_snr_threshold``."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.periodicity import PeriodicityResult
    from srtb_tpu.pipeline.runtime import has_signal
    out = []
    for snr, trials, thr in cases:
        snr = np.asarray(snr, np.float32)
        k = snr.shape[-1]
        res = PeriodicityResult(
            zero_count=np.zeros(1, np.int32),
            time_series=np.zeros((1, 8), np.float32),
            boxcar_lengths=(1,),
            signal_counts=np.zeros((1, 3), np.int32),
            boxcar_series=np.zeros((1, 1, 8), np.float32),
            snr_peaks=np.zeros((1, 3), np.float32),
            candidate_bins=np.zeros((1, k), np.int32),
            candidate_snr=snr,
            candidate_harmonics=np.ones((1, k), np.int32),
            folded_profiles=np.zeros((1, k, 4), np.float32),
            candidate_trials=tuple(trials))
        out.append(has_signal(Config(search_mode="periodicity",
                                     periodicity_snr_threshold=thr), res))
    return {"verdicts": np.array(out)}


def dm_grid_search(fields: dict, raw: np.ndarray, dm_list: list) -> dict:
    """The reference's DM grid as its tests run it: the cleaned spectrum
    (unpack, R2C, stage 1 without the chirp), the host chirp bank on a
    one-device ``dm`` mesh, ``dm_trial_search`` and ``best_trial``."""
    import jax.numpy as jnp
    from srtb_tpu.config import Config
    from srtb_tpu.ops import dedisperse as dd
    from srtb_tpu.ops import fft as F
    from srtb_tpu.ops import rfi
    from srtb_tpu.ops import unpack as U
    from srtb_tpu.parallel import dm_grid
    from srtb_tpu.parallel import mesh as M
    from srtb_tpu.pipeline.segment import SegmentProcessor
    cfg = Config(**fields)
    proc = SegmentProcessor(cfg.replace(dm=0.0))
    spec = F.segment_rfft(U.unpack(jnp.asarray(raw),
                                   cfg.baseband_input_bits))
    spec = rfi.mitigate_rfi_average_and_normalize(
        spec, cfg.mitigate_rfi_average_method_threshold, proc.norm_coeff)
    spec_ri = jnp.stack([jnp.real(spec), jnp.imag(spec)])
    f_min, f_c, df = dd.spectrum_frequencies(cfg, proc.n_spectrum)
    mesh = M.dm_mesh(1)
    bank = dm_grid.build_chirp_bank(dm_list, proc.n_spectrum, f_min, df,
                                    f_c)
    res = dm_grid.dm_trial_search(
        spec_ri, bank, dm_list, mesh, channel_count=proc.channel_count,
        time_reserved_count=proc.time_reserved_count,
        snr_threshold=cfg.signal_detect_signal_noise_threshold,
        max_boxcar_length=cfg.signal_detect_max_boxcar_length,
        sk_threshold=cfg.mitigate_rfi_spectral_kurtosis_threshold)
    idx, snr = dm_grid.best_trial(res)
    return {"spectrum_ri": spec_ri, "bank": bank, "result": res,
            "best": np.array([idx]), "best_snr": np.array([snr])}


def one_device_mesh():
    """The reference's (dm 1, seq 1) mesh on its first device (the pytest
    process's XLA_FLAGS give the runner eight virtual CPU devices, and
    ``make_mesh(1, 1)`` would take them all)."""
    import jax
    from srtb_tpu.parallel import mesh as M
    return M.make_mesh(1, 1, devices=jax.devices()[:1])


def dist_segment(fields: dict, raw: np.ndarray, dm_list: list,
                 window_name: str = "rectangle") -> dict:
    """The reference's ``DistSegmentProcessor`` on a (dm 1, seq 1) mesh."""
    from srtb_tpu.config import Config
    from srtb_tpu.parallel.segment_dist import DistSegmentProcessor
    dist = DistSegmentProcessor(Config(**fields), one_device_mesh(),
                                dm_list=dm_list, window_name=window_name)
    return {"result": dist.process(raw)}


def dm_search_pipeline(fields: dict) -> dict:
    """The reference's ``DMSearchPipeline(cfg, mesh=...).run()`` on one
    device: its statistics and the records it appended."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.runtime import DMSearchPipeline
    pipe = DMSearchPipeline(Config(**fields), mesh=one_device_mesh())
    stats = pipe.run()
    with open(pipe.trials_path) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    return {"segments": stats.segments, "signals": stats.signals,
            "records": np.array(lines)}


def refusals(cases: list) -> dict:
    """The exception type and message the reference raises for each case:
    ``("dist", fields, dm_list)`` builds a ``DistSegmentProcessor`` on a
    (dm 1, seq 1) mesh, ``("mode", fields)`` resolves the search mode."""
    from srtb_tpu.config import Config
    from srtb_tpu.parallel.segment_dist import DistSegmentProcessor
    from srtb_tpu.pipeline import registry
    out = []
    for kind, fields, *rest in cases:
        try:
            if kind == "dist":
                DistSegmentProcessor(Config(**fields), one_device_mesh(),
                                     dm_list=rest[0])
            else:
                registry.resolve_mode(Config(**fields))
            out.append("")
        except Exception as e:  # the case's refusal, reported
            out.append(f"{type(e).__name__}: {e}")
    return {"messages": np.array(out)}


def correlate(x1: np.ndarray, x2: np.ndarray) -> dict:
    """The JAX package's ``correlator.correlate`` and its ``main`` on
    files (``corr.bin``'s bytes)."""
    import tempfile
    from srtb_tpu.tools import correlator as C
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, name) for name in ("a.bin", "b.bin",
                                                    "corr.bin")]
        x1.view(np.uint8).tofile(paths[0])
        x2.view(np.uint8).tofile(paths[1])
        rc = C.main(paths)
        corr_bin = np.fromfile(paths[2], dtype=np.uint8)
    return {"corr": C.correlate(x1, x2), "rc": rc, "corr_bin": corr_bin}


def ref_plot_dm_curve(argv: list, matplotlib: bool) -> dict:
    """:func:`run_printing` of the JAX package's ``plot_dm_curve.main``,
    and the exception it raises (without matplotlib it raises)."""
    from srtb_tpu.tools.plot_dm_curve import main
    try:
        return run_printing(main, argv, matplotlib)
    except ImportError as e:
        return {"error": type(e).__name__}


# the resilience counters both packages keep (the reference in its
# metrics registry, the port in Pipeline.counters)
RESILIENCE_COUNTERS = (
    "plan_demotions", "plan_promotions", "device_reinits",
    "plan_ladder_level", "retries_total", "retries_ingest", "retries_h2d",
    "retries_dispatch", "retries_fetch", "retries_sink_write",
    "retries_checkpoint", "data_loss_total", "watchdog_requeues",
    "segments_dropped", "shed_waterfalls", "shed_baseband", "degrade_level",
    "degrade_steps", "degrade_recoveries", "faults_injected",
    "worker_restarts", "worker_restarts_sink_drain")


def ladder_plan_names(fields: dict, env: dict | None = None,
                      base_staged: bool | None = None,
                      ladder: str = "auto") -> dict:
    """The reference's demotion rungs of a config: each rung's step, its
    staged argument and its plan name (composed as
    :func:`resolved_plan_name` composes it, ``+period`` for the
    periodicity mode)."""
    from srtb_tpu.config import Config
    from srtb_tpu.resilience.demote import ladder_rungs, parse_ladder
    with environ(env):
        rungs = ladder_rungs(Config(**fields), base_staged,
                             parse_ladder(ladder))
    plans = []
    for r in rungs:
        name = resolved_plan_name(dataclasses.asdict(r.cfg), env,
                                  staged=r.staged)["plan"]
        if str(r.cfg.search_mode).lower() == "periodicity":
            name += "+period"
        plans.append(name)
    return {"steps": np.array([r.step for r in rungs] or [""]),
            "staged": np.array([str(r.staged) for r in rungs] or [""]),
            "plans": np.array(plans or [""])}


class CaptureSink:
    """Each pushed segment's decisions and time series, and its gate
    verdict (the chaos soak's capture sink)."""

    def __init__(self):
        self.out = []

    def push(self, work, positive):
        det = work.detect
        wf = work.waterfall
        if wf is not None:
            wf = np.asarray(wf.cpu() if hasattr(wf, "cpu") else wf)
            if not np.iscomplexobj(wf):  # the reference's (re, im) stack
                wf = wf[0] + 1j * wf[1]
        self.out.append((np.asarray(det.signal_counts).copy(),
                         np.asarray(det.zero_count).copy(),
                         np.asarray(det.time_series).copy(),
                         bool(positive), wf))

    def arrays(self) -> dict:
        if not self.out:
            return {"segments": 0}
        res = {"segments": len(self.out),
               "signal_counts": np.stack([o[0] for o in self.out]),
               "zero_count": np.stack([o[1] for o in self.out]),
               "time_series": np.stack([o[2] for o in self.out]),
               "positive": np.array([o[3] for o in self.out])}
        if all(o[4] is not None for o in self.out):
            res["waterfall"] = np.stack([o[4] for o in self.out]).astype(
                np.complex64)
        return res


def resilience_run(pipeline_cls, cfg, counters_of, capture: bool = True,
                   source=None, max_segments=None, **kwargs) -> dict:
    """One run of ``pipeline_cls(cfg, ...)``, with a capture sink or the
    configured writers: its captured decisions, the files under the
    output prefix's directory, its counters (``counters_of(pipe, name)``),
    the plans the healer installed, the degradation level of each emitted
    segment, and the name of the exception that ended it ("" when it
    completed)."""
    sink = CaptureSink()
    if capture:
        kwargs["sinks"] = [sink]
    pipe = pipeline_cls(cfg, source=source, **kwargs)
    plans, levels = [], []
    swap = pipe._swap_processor

    def recording_swap(newp):
        plans.append(str(newp.plan_name))
        swap(newp)
    pipe._swap_processor = recording_swap
    ladder = getattr(pipe, "_ladder", None)
    if ladder is not None:
        observe = ladder.observe

        def recording_observe(*args):
            level = observe(*args)
            levels.append(level)
            return level
        ladder.observe = recording_observe
    error = ""
    try:
        with pipe:
            pipe.run(max_segments)
    except Exception as e:  # noqa: BLE001 - reported by name
        error = type(e).__name__
    out_dir = os.path.dirname(cfg.baseband_output_file_prefix)
    ckpt = {}
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        with open(cfg.checkpoint_path) as f:
            state = json.load(f)
        ckpt = {k: state[k] for k in ("segments_done", "file_offset_bytes")}
    res = {"error": error, "checkpoint": ckpt, "plans": np.array(plans or [""]),
           "levels": np.array(levels, dtype=np.int64),
           "files": np.array(sorted(
               f for f in os.listdir(out_dir)
               if f.startswith(os.path.basename(
                   cfg.baseband_output_file_prefix))) or [""]),
           "unfired": len(pipe.faults.unfired()) if pipe.faults else 0,
           "counters": {k: float(counters_of(pipe, k))
                        for k in RESILIENCE_COUNTERS}}
    res.update(sink.arrays())
    return res


def ref_resilience_run(fields: dict, capture: bool = True,
                       source_fields: dict | None = None,
                       max_segments=None) -> dict:
    """:func:`resilience_run` on the reference's ``Pipeline``; with
    ``source_fields`` the source is a file reader of that config (a
    stand-in for a live source when ``fields`` has no input file)."""
    from srtb_tpu.config import Config
    from srtb_tpu.io.file_input import make_file_source
    from srtb_tpu.pipeline.runtime import Pipeline
    from srtb_tpu.utils.metrics import metrics
    metrics.reset()
    source = None
    if source_fields is not None:
        source = make_file_source(Config(**source_fields))
    try:
        return resilience_run(Pipeline, Config(**fields),
                              lambda _pipe, k: metrics.get(k), capture,
                              source=source, max_segments=max_segments)
    finally:
        metrics.reset()


def ref_parse_plans(texts: list) -> dict:
    """The reference's ``parse_plan`` of each text: its entries printed,
    or the name of the exception it raises."""
    from srtb_tpu.resilience.faults import parse_plan
    out = []
    for text in texts:
        try:
            out.append(",".join(str(s) for s in parse_plan(text)))
        except ValueError as e:
            out.append(type(e).__name__)
    return {"specs": np.array(out)}


def ref_backoffs(sites: list, attempts: int, base: float, cap: float
                 ) -> dict:
    """The reference's ``RetryPolicy.backoff`` for each (site, attempt)."""
    from srtb_tpu.resilience.retry import RetryPolicy
    p = RetryPolicy(max_attempts=attempts + 1, backoff_base_s=base,
                    backoff_max_s=cap)
    return {"backoff": np.array([[p.backoff(s, a)
                                  for a in range(1, attempts + 1)]
                                 for s in sites])}


def degrade_script(ladder_cls, high: float, low: float, hold: int,
                   observations: list) -> dict:
    """A degradation ladder's levels over (occupancy, loss) observations."""
    ladder = ladder_cls(high=high, low=low, hold=hold)
    return {"levels": np.array([ladder.observe(o, bool(loss))
                                for o, loss in observations])}


def ref_degrade_script(*args) -> dict:
    from srtb_tpu.resilience.degrade import DegradationLadder
    return degrade_script(DegradationLadder, *args)


def classifying_supervisor_script(supervisor_cls, errors, max_restarts: int,
                                  times: list) -> dict:
    """A classifying supervisor's decisions on a clock reading ``times``
    for the crashes ``errors`` (one each)."""
    clock_values = list(times)
    sup = supervisor_cls("test", max_restarts=max_restarts, window_s=60.0,
                         clock=lambda: clock_values.pop(0))
    return {"decisions": np.array([sup.should_restart(e) for e in errors]),
            "restarts": sup.restarts}


def ref_classifying_supervisor(kinds: list, max_restarts: int,
                               times: list) -> dict:
    """:func:`classifying_supervisor_script` on the reference's
    supervisor with its own error types (``transient``, ``fatal``,
    ``data_loss``, ``device``, ``plain``)."""
    from srtb_tpu.resilience import errors as E
    from srtb_tpu.resilience.supervisor import Supervisor
    make = {"transient": E.TransientError, "fatal": E.FatalError,
            "data_loss": E.DataLossError, "device": E.DeviceOOM,
            "plain": RuntimeError}
    return classifying_supervisor_script(
        Supervisor, [make[k]("crash") for k in kinds], max_restarts, times)


def drop_oldest_script(buffer_cls, n: int, capacity: int) -> dict:
    """A drop-oldest buffer of ``capacity`` over ``n`` segments, consumed
    only after its pump has read them all: the timestamps it yields, its
    drop count and its drops by stream."""
    from types import SimpleNamespace
    source = (SimpleNamespace(data=np.zeros(4, np.uint8), timestamp=i,
                              data_stream_id=i % 2) for i in range(n))
    buf = buffer_cls(source, capacity=capacity)
    buf._thread.join(30)
    got = [seg.timestamp for seg in buf]
    buf.close()
    return {"yielded": np.array(got), "dropped": buf.dropped,
            "by_stream": np.array(sorted(buf.dropped_by_stream.items()))}


def ref_drop_oldest_script(*args) -> dict:
    from srtb_tpu.io.backpressure import DropOldestSegmentBuffer
    return drop_oldest_script(DropOldestSegmentBuffer, *args)


# ------------------------------------------------------ observability
# The scripted runners of tests/test_torch_metrics.py, test_torch_events.py
# and test_torch_telemetry.py.  Each takes the package's name ("srtb_tpu"
# or "srtb_tpu_torch"), so the same script drives the JAX package's
# modules here and the port's in the pytest process.

class FakeClock:
    """A settable monotonic clock (seconds)."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class fake_time:
    """Replace a module's ``time`` with ``clock`` (``monotonic``,
    ``perf_counter``, and ``time`` at a fixed epoch offset) inside the
    block."""

    def __init__(self, module, clock: FakeClock):
        self.module, self.clock = module, clock

    def __enter__(self):
        import time as real
        import types
        self.saved = self.module.time
        c = self.clock
        self.module.time = types.SimpleNamespace(
            monotonic=c, perf_counter=c, time=lambda: 1.7e9 + c(),
            sleep=real.sleep)
        return c

    def __exit__(self, *exc):
        self.module.time = self.saved


def _pkg(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.utils.{name}")


def metrics_script(pkg: str, script: list) -> dict:
    """A fresh ``Metrics`` of ``pkg`` on a fake clock, driven by
    ``script``: ``("add"|"set", name, value, labels)``, ``("observe",
    name, value, labels, buckets)``, ``("window", name, value,
    window_s)``, ``("tick", seconds)`` and ``("quantile", name, labels,
    q)``.  Returns the snapshot (JSON), the Prometheus text and the
    quantiles read."""
    M = _pkg(pkg, "metrics")
    clock = FakeClock()
    quantiles = []
    with fake_time(M, clock):
        m = M.Metrics()
        for op in script:
            kind = op[0]
            if kind == "add":
                m.add(op[1], op[2], labels=op[3])
            elif kind == "set":
                m.set(op[1], op[2], labels=op[3])
            elif kind == "observe":
                h = (m.histogram(op[1], labels=op[3]) if op[4] is None
                     else m.histogram(op[1], buckets=op[4], labels=op[3]))
                h.observe(op[2])
            elif kind == "window":
                w = m.window(op[1], op[3])
                if w._clock is not clock:  # new: onto the fake clock
                    w._clock, w._start = clock, clock()
                w.add(op[2])
            elif kind == "tick":
                clock.advance(op[1])
            elif kind == "quantile":
                quantiles.append(m.histogram(op[1], labels=op[2])
                                 .quantile(op[3]))
        snap = json.dumps(m.snapshot(), sort_keys=True)
        prom = m.prometheus()
    return {"snapshot": snap, "prometheus": prom,
            "quantiles": np.array(quantiles, dtype=np.float64)}


def events_script(pkg: str, ring_size: int, groups: list,
                  trace: int) -> dict:
    """An ``EventHub(ring_size)`` of ``pkg`` on a fake clock: each group
    ``(thread_name, events)`` emits its events ``(dt, etype, trace,
    stream, seg, dur, info)`` on a new thread of that name, one group
    after the other.  Returns the merged dump (JSON lines), the dump of
    ``trace`` and the ``dump_jsonl`` file's lines; then the module's
    own hub: ``configure``, ``set_current``, ambient ``emit`` and
    disarming."""
    import tempfile
    import threading
    E = _pkg(pkg, "events")
    clock = FakeClock()
    out = {}
    with fake_time(E, clock):
        hub = E.EventHub(ring_size)
        for name, evs in groups:
            def emit_all(evs=evs):
                for dt, etype, tr, stream, seg, dur, info in evs:
                    clock.advance(dt)
                    hub.emit(etype, trace=tr, stream=stream, seg=seg,
                             dur=dur, info=info)
            t = threading.Thread(target=emit_all, name=name)
            t.start()
            t.join()
        out["dump"] = np.array([json.dumps(e, sort_keys=True)
                                for e in hub.dump()])
        out["trace"] = np.array([json.dumps(e, sort_keys=True)
                                 for e in hub.dump(trace=trace)] or [""])
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "sub", "events.jsonl")
            out["jsonl_count"] = hub.dump_jsonl(path)
            with open(path) as f:
                out["jsonl"] = np.array(f.read().splitlines())
        saved = E.hub
        try:
            E.configure(True, ring_size=8)
            first = E.hub
            E.configure(True, ring_size=8)
            out["kept"] = E.hub is first
            E.set_current(41, "beam")
            out["current"] = np.array(E.current(), dtype=object).astype(str)
            E.emit("retry", info="fetch:transient:1")
            E.emit("slo", trace=0, stream="", info="loss:ok->burning")
            E.emit("stage.sink", trace=7, seg=3, dur=0.25)
            out["module"] = np.array([json.dumps(e, sort_keys=True)
                                      for e in E.hub.dump()])
            E.configure(False)
            E.emit("retry")
            out["disarmed"] = E.hub is None
        finally:
            E.hub = saved
    return out


def span_record(pkg: str, counters: list, kwargs: dict) -> dict:
    """``segment_span(**kwargs)`` of ``pkg`` after ``counters`` (``(name,
    value, labels)``) were set in its freshly reset registry; the record
    as JSON, less its wall-clock ``ts``."""
    T = _pkg(pkg, "telemetry")
    M = _pkg(pkg, "metrics")
    M.metrics.reset()
    for name, value, labels in counters:
        M.metrics.set(name, value, labels=labels)
    rec = T.segment_span(**kwargs)
    rec.pop("ts")
    M.metrics.reset()
    return {"record": json.dumps(rec, sort_keys=True)}


def journal_script(pkg: str, directory: str, max_bytes: int,
                   compress: bool, records: list, orphans: list) -> dict:
    """A ``SpanJournal`` of ``pkg`` under ``directory`` (the ``orphans``,
    ``(name, text)``, written there first, as a rotation a previous life
    died in), ``records`` written one by one: the files left, the
    active file's text, the rotated generation's name and text."""
    import gzip
    T = _pkg(pkg, "telemetry")
    os.makedirs(directory, exist_ok=True)
    for i, (name, text) in enumerate(orphans):
        p = os.path.join(directory, name)
        with open(p, "w") as f:
            f.write(text)
        os.utime(p, (1000 + i, 1000 + i))
    path = os.path.join(directory, "spans.jsonl")
    with T.SpanJournal(path, max_bytes=max_bytes, compress=compress) as j:
        for rec in records:
            j.write(rec)
    gen = T.rotated_generation(path)
    rotated = ""
    if gen is not None:
        opener = gzip.open if gen.endswith(".gz") else open
        with opener(gen, "rt") as f:
            rotated = f.read()
    with open(path) as f:
        active = f.read()
    return {"files": np.array(sorted(os.listdir(directory))),
            "active": active, "rotated": rotated,
            "generation": os.path.basename(gen) if gen else ""}


def health_script(pkg: str, script: list) -> dict:
    """``health()`` of ``pkg`` on a fake clock, its registry and stream
    table fresh, the SLO disarmed: ``("register"|"release", name)``,
    ``("mark", stream or None)``, ``("tick", seconds)``, ``("health",
    stale_after_s)`` (each report as JSON)."""
    T = _pkg(pkg, "telemetry")
    M = _pkg(pkg, "metrics")
    _pkg(pkg, "slo").reset()
    M.metrics.reset()
    T._ADMITTED_STREAMS.clear()
    clock = FakeClock()
    reports = []
    with fake_time(T, clock):
        for op in script:
            if op[0] == "register":
                T.register_stream(op[1])
            elif op[0] == "release":
                T.release_stream(op[1])
            elif op[0] == "mark":
                M.metrics.add("segments")
                T.mark_segment(op[1])
            elif op[0] == "tick":
                clock.advance(op[1])
            elif op[0] == "health":
                reports.append(json.dumps(T.health(op[1]), sort_keys=True))
    T._ADMITTED_STREAMS.clear()
    M.metrics.reset()
    return {"reports": np.array(reports)}


def slo_script(pkg: str, params: dict, script: list,
               cfg_fields: dict) -> dict:
    """A ``SloTracker(**params)`` of ``pkg`` on a fake clock, its
    registry and flight recorder fresh: ``("seg", stream, latency_s)``,
    ``("drop", stream, n)``, ``("canary", stream, ok)``, ``("tick",
    seconds)`` and ``("eval",)`` (each report as JSON).  Returns the
    reports, the ``slo_*`` gauges, the ``slo`` events, and the
    objectives ``SloTracker.from_config`` arms for ``cfg_fields``."""
    S = _pkg(pkg, "slo")
    M = _pkg(pkg, "metrics")
    E = _pkg(pkg, "events")
    config = importlib.import_module(f"{pkg}.config")
    M.metrics.reset()
    saved = E.hub
    E.hub = E.EventHub(256)
    clock = FakeClock()
    t = S.SloTracker(clock=clock, **params)
    reports = []
    try:
        for op in script:
            if op[0] == "seg":
                t.note_segment(op[1], op[2])
            elif op[0] == "drop":
                t.note_dropped(op[1], op[2])
            elif op[0] == "canary":
                t.note_canary(op[1], op[2])
            elif op[0] == "tick":
                clock.advance(op[1])
            elif op[0] == "eval":
                reports.append(json.dumps(t.evaluate(), sort_keys=True))
        evs = [f"{e['stream']}|{e['info']}" for e in E.hub.dump()
               if e["type"] == "slo"]
    finally:
        E.hub = saved
    gauges = {name: json.dumps(M.metrics.labeled_series(name),
                               sort_keys=True)
              for name in ("slo_burn_rate", "slo_state")}
    armed = S.SloTracker.from_config(config.Config(**cfg_fields))
    M.metrics.reset()
    return {"reports": np.array(reports), "events": np.array(evs or [""]),
            "gauges": gauges,
            "objectives": np.array(list(armed.objectives) if armed
                                   else [""])}


RESILIENCE_LAYERS = ("retry", "faults", "supervisor", "degrade",
                     "drop_oldest", "healer")


def resilience_registry_script(pkg: str, layer: str) -> dict:
    """One resilience layer of ``pkg`` driven by a fixed script, from a
    fresh registry and flight recorder: the registry's snapshot of flat
    and labeled series (less the clock's, as JSON) and the events
    ``type|stream|seg|info``."""
    from types import SimpleNamespace
    M = _pkg(pkg, "metrics")
    E = _pkg(pkg, "events")
    errors = importlib.import_module(f"{pkg}.resilience.errors")
    M.metrics.reset()
    saved = E.hub
    E.hub = E.EventHub(256)
    try:
        if layer == "retry":
            R = importlib.import_module(f"{pkg}.resilience.retry")
            p = R.RetryPolicy(max_attempts=3, backoff_base_s=0.0)
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 3:
                    raise errors.DataLossError("torn")
                return 7
            E.set_current(5, "")
            R.retry_call(flaky, p, "fetch", sleep=lambda s: None)
            try:
                R.retry_call(lambda: (_ for _ in ()).throw(
                    errors.TransientError("x")), p, "ingest",
                    sleep=lambda s: None)
            except errors.TransientError:
                pass
        elif layer == "faults":
            F = importlib.import_module(f"{pkg}.resilience.faults")
            inj = F.FaultInjector.from_plan(
                "ingest:raise@0,fetch:stall=0.01@1,dispatch:oom@2,"
                "beam9:dispatch:oom@0", stream="")
            for site, index in (("ingest", 0), ("ingest", 0), ("fetch", 1),
                                ("dispatch", 2), ("dispatch", 0)):
                try:
                    inj.fire(site, index)
                except Exception:  # noqa: BLE001 - the injected faults
                    pass
        elif layer == "supervisor":
            Sup = importlib.import_module(f"{pkg}.resilience.supervisor")
            ticks = iter([0.0, 1.0, 2.0, 3.0, 4.0])
            sup = Sup.Supervisor("sink_drain", max_restarts=2,
                                 clock=lambda: next(ticks))
            for _ in range(3):
                sup.should_restart(errors.TransientError("crash"))
            quiet = Sup.Supervisor("device_reinit", counter=None)
            quiet.should_restart(errors.TransientError("crash"))
        elif layer == "degrade":
            D = importlib.import_module(f"{pkg}.resilience.degrade")
            ladder = D.DegradationLadder(high=0.9, low=0.25, hold=2,
                                         stream="beam1")
            for occ, loss in [(1.0, 0)] * 7 + [(0.0, 0)] * 7:
                ladder.observe(occ, bool(loss))
        elif layer == "drop_oldest":
            B = importlib.import_module(f"{pkg}.io.backpressure")
            source = (SimpleNamespace(data=np.zeros(4, np.uint8),
                                      timestamp=i, data_stream_id=i % 2)
                      for i in range(9))
            buf = B.DropOldestSegmentBuffer(source, capacity=3)
            buf._thread.join(30)
            list(buf)
            buf.close()
        elif layer == "healer":
            config = importlib.import_module(f"{pkg}.config")
            demote = importlib.import_module(f"{pkg}.resilience.demote")
            cfg = config.Config(
                baseband_input_count=1 << 16, baseband_input_bits=2,
                spectrum_channel_count=8, fft_strategy="four_step",
                fused_tail="on", use_pallas=True, use_pallas_sk=True,
                micro_batch_segments=2, baseband_reserve_sample=True,
                stream_name="beam1")
            h = demote.ComputeHealer(cfg, lambda c, staged: ("plan", staged),
                                     promote_after=1, reinit_max=2)
            h.demote(errors.DeviceOOM("oom"), "oom")
            h.demote(errors.DeviceOOM("oom"), "oom")
            h.note_healthy()
            if h.promote_due():
                h.promote()
            h.reinit(errors.DeviceOOM("halt"))
        # less the clock's series: the elapsed time and the window rates
        snap = {k: v for k, v in M.metrics.snapshot().items()
                if k != "elapsed_s" and "_per_sec_" not in k}
        evs = [f"{e['type']}|{e['stream']}|{e['seg']}|{e['info']}"
               for e in E.hub.dump()]
    finally:
        E.hub = saved
        M.metrics.reset()
    return {"snapshot": json.dumps(snap, sort_keys=True),
            "events": np.array(evs or [""])}


def observed_main(argv: list, journal: str, events_path: str) -> dict:
    """``srtb-main`` on ``argv`` from a fresh metrics registry and flight
    recorder: its exit
    code, its journal's records and its flight-recorder dump (JSON
    lines), and the registry's snapshot after the run (JSON)."""
    from srtb_tpu.tools.main import main
    from srtb_tpu.utils import events
    from srtb_tpu.utils.metrics import metrics
    metrics.reset()
    events.configure(False)  # the run arms a fresh flight recorder
    rc = main(list(argv))
    with open(journal) as f:
        spans = f.read().splitlines()
    with open(events_path) as f:
        evs = f.read().splitlines()
    snap = json.dumps(metrics.snapshot(), sort_keys=True)
    metrics.reset()
    return {"rc": rc, "journal": np.array(spans), "events": np.array(evs),
            "snapshot": snap}


def ref_hbm_passes(flags: list) -> dict:
    """The reference's ``hbm_passes`` for each ``(fused_tail, skzap,
    front_fuse)``, by its own lines of ``SegmentProcessor.__init__`` run
    on those flags (no processor is built, so a 2^30 plan costs
    nothing)."""
    import inspect
    import textwrap
    import types
    from srtb_tpu.pipeline.segment import SegmentProcessor
    lines = inspect.getsource(SegmentProcessor.__init__).splitlines()
    first = next(i for i, x in enumerate(lines)
                 if "self.hbm_passes = (" in x)
    last = next(i for i, x in enumerate(lines)
                if i > first and "self.hbm_passes = 2" in x)
    code = textwrap.dedent("\n".join(lines[first:last + 1]))
    out = []
    for tail, skzap, ffuse in flags:
        ns = {"self": types.SimpleNamespace(fused_tail=tail, _skzap=skzap,
                                            front_fuse=ffuse)}
        exec(code, ns)
        out.append(ns["self"].hbm_passes)
    return {"passes": np.array(out, dtype=np.int64)}


def _refill_reference_window() -> None:
    """The JAX package's engine ends a run early, its source unread, when
    the sink thread drains the whole in-flight window between two of the
    engine thread's looks at it (``Pipeline._run_engine``'s parked-window
    branch, ROADMAP C2); the port's engine fills the window again there.
    In this interpreter the reference's engine is recompiled from its own
    source with that branch changed the port's way, so a comparison run
    never depends on a thread race (nothing under ``srtb_tpu/`` is
    edited)."""
    import inspect
    import textwrap
    from srtb_tpu.pipeline import runtime as R
    parked = "if want_more() and live_count() > 0 and sink_alive():"
    lines, first = inspect.getsourcelines(R.Pipeline._run_engine)
    src = "".join(lines)
    assert src.count(parked) == 1, "the parked-window branch moved"
    line = next(x for x in lines if parked in x)
    pad = line[:line.index(parked)]
    src = src.replace(line, f"{pad}if want_more() and live_count() == 0:\n"
                            f"{pad}    continue\n{line}")
    code = compile("\n" * (first - 1) + textwrap.dedent(src), R.__file__,
                   "exec")
    scope: dict = {}
    exec(code, R.__dict__, scope)
    R.Pipeline._run_engine = scope["_run_engine"]


def _main(req: str, out: str) -> None:
    _apply_jax_shim()
    _refill_reference_window()
    with open(req, "rb") as f:
        jobs = pickle.load(f)
    results: dict = {}
    for job in jobs:
        fn = _resolve(job["fn"])
        res = fn(*job.get("args", ()), **job.get("kwargs", {}))
        _flatten(job["key"], res, results)
    np.savez(out, **results)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _main(sys.argv[1], sys.argv[2])

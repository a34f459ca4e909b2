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


def run_reference(jobs: list[dict], tmp_dir) -> dict[str, np.ndarray]:
    """Run ``jobs`` in one reference interpreter; returns the flattened
    results.  Raises with the runner's output when it fails."""
    tmp_dir = Path(tmp_dir)
    req = tmp_dir / "reference_jobs.pkl"
    out = tmp_dir / "reference_out.npz"
    with open(req, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
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
    resolution raises)."""
    from srtb_tpu.config import Config
    from srtb_tpu.ops import fft as F
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


def _main(req: str, out: str) -> None:
    _apply_jax_shim()
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

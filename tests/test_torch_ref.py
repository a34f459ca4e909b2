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
import threading
import time
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


# ------------------------------------------------- the port's worlds

# how long a world's rank waits for its peers (the rendezvous and each
# collective), and how long a whole world may take
WORLD_GLOO_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 240


def run_world(jobs: list[dict], tmp_dir, world: int,
              env_of=None) -> list[dict[str, np.ndarray]]:
    """Run ``jobs`` (as :func:`run_reference` takes them, each a port
    function) in ``world`` processes that form one gloo process group
    (``file://`` rendezvous under ``tmp_dir``, so no port is taken), one
    thread each; every rank runs every job in order and returns its
    flattened results, rank by rank.  ``env_of(rank)``: extra environment
    of a rank.  A rank that fails, or a world past ``WORLD_TIMEOUT_S``,
    raises with the ranks' output."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    with open(tmp_dir / "world_jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    procs = []
    for r in range(world):
        env = dict(os.environ)
        env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
        env.update(env_of(r) if env_of is not None else {})
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--world-rank", str(r), str(world),
             str(tmp_dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [""] * world
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"world of {world} ranks past {WORLD_TIMEOUT_S}"
                           " s:\n" + "\n".join(o[-2000:] for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError("world ranks failed: " + "\n".join(
            f"rank {r} rc {procs[r].returncode}:\n{outs[r][-4000:]}"
            for r in failed))
    results = []
    for r in range(world):
        with np.load(tmp_dir / f"world_rank{r}.npz",
                     allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
    return results


def _world_rank(rank: int, world: int, tmp_dir: str) -> None:
    """One rank of :func:`run_world` (the port only: nothing of JAX)."""
    import torch
    torch.set_num_threads(1)
    from srtb_tpu_torch.parallel import distributed
    distributed.initialize(f"file://{tmp_dir}/world_rendezvous", world,
                           rank, device="cpu",
                           timeout_s=WORLD_GLOO_TIMEOUT_S)
    with open(os.path.join(tmp_dir, "world_jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    results: dict = {}
    for job in jobs:
        fn = _resolve(job["fn"])
        _flatten(job["key"], fn(*job.get("args", ()),
                                **job.get("kwargs", {})), results)
    np.savez(os.path.join(tmp_dir, f"world_rank{rank}.npz"), **results)
    distributed.shutdown()


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


def _ref_seq_mesh(n_seq: int):
    import jax
    from srtb_tpu.parallel import mesh as M
    assert len(jax.devices()) >= n_seq, "the runner needs the CPU devices"
    return M.seq_mesh(n_seq)


def ref_dist_fft(x: np.ndarray, inverse: bool = False,
                 rows_impl: str = "xla", len_cap=None,
                 n_seq: int = 8) -> dict:
    """The reference's ``dist_fft`` on its ``n_seq``-device seq mesh."""
    import jax.numpy as jnp
    from srtb_tpu.parallel import dist_fft as DF
    return {"y": np.asarray(DF.dist_fft(
        jnp.asarray(x), _ref_seq_mesh(n_seq), inverse=inverse,
        rows_impl=rows_impl, len_cap=len_cap))}


def ref_dist_rfft(x: np.ndarray, n_seq: int = 8) -> dict:
    """The reference's ``dist_rfft_drop_nyquist`` on ``n_seq`` devices."""
    import jax.numpy as jnp
    from srtb_tpu.parallel import dist_fft as DF
    return {"y": np.asarray(DF.dist_rfft_drop_nyquist(
        jnp.asarray(x), _ref_seq_mesh(n_seq)))}


def _collect_collectives(jaxpr, out: list) -> list:
    """(primitive, mesh axes) of every collective in a jaxpr tree (the
    reference's ``tests/test_parallel.py`` inventory walk)."""
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("all_to_all", "ppermute", "all_gather",
                    "reduce_scatter") or "psum" in name:
            ax = eqn.params.get("axes") or eqn.params.get("axis_name")
            ax = (ax,) if isinstance(ax, str) else tuple(ax)
            out.append((name.replace("psum_invariant", "psum"), ax))
        for v in eqn.params.values():
            for item in (v if isinstance(v, (list, tuple)) else [v]):
                if hasattr(item, "jaxpr"):
                    _collect_collectives(item.jaxpr, out)
                elif hasattr(item, "eqns"):
                    _collect_collectives(item, out)
    return out


def ref_dist_step(fields: dict, raw: np.ndarray, dm_list: list, n_dm: int,
                  n_seq: int, window_name: str = "rectangle",
                  env: dict | None = None, inventory: bool = False) -> dict:
    """The reference's ``DistSegmentProcessor`` on a (dm, seq) mesh of its
    CPU devices, under ``env``; with ``inventory`` also its step's
    collective inventory (``name axis count`` lines, sorted)."""
    from collections import Counter

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from srtb_tpu.config import Config
    from srtb_tpu.parallel import mesh as M
    from srtb_tpu.parallel.segment_dist import DistSegmentProcessor
    cfg = Config(**fields)
    with environ(env):
        mesh = M.make_mesh(n_dm=n_dm, n_seq=n_seq,
                           devices=jax.devices()[:n_dm * n_seq])
        dist = DistSegmentProcessor(cfg, mesh, dm_list=dm_list,
                                    window_name=window_name)
        out = {"result": dist.process(raw)}
        if inventory:
            raw_dev = jax.device_put(np.zeros(cfg.segment_bytes(
                dist.fmt.data_stream_count), np.uint8),
                NamedSharding(mesh, P("seq")))
            args = [raw_dev, dist.chirp_bank, dist.rfi_mask]
            if dist.window is not None:
                args.append(dist.window)
            got = Counter(_collect_collectives(
                jax.make_jaxpr(dist._step)(*args).jaxpr, []))
            out["inventory"] = np.array(sorted(
                f"{name} {','.join(ax)} {c}" for (name, ax), c in
                got.items()))
    return out


def ref_hybrid_layouts() -> dict:
    """The reference's hybrid meshes on its eight CPU devices: one slice
    at n_seq 2, two faked slices at n_seq 2 (device ids and slice
    indices), and the bad n_seq's message."""
    import jax
    from srtb_tpu.parallel import distributed as D

    class FakeDev:
        def __init__(self, d, s):
            self._d, self.slice_index, self.id = d, s, d.id

    one = D.hybrid_dm_seq_mesh(n_seq=2)
    devs = jax.devices()
    fake = [FakeDev(d, s) for s, half in
            enumerate((devs[:4], devs[4:])) for d in half]
    two = D.hybrid_dm_seq_mesh(n_seq=2, devices=fake).devices
    try:
        D.hybrid_dm_seq_mesh(n_seq=3)
        bad = ""
    except ValueError as e:
        bad = f"ValueError: {e}"
    return {"one": np.array([[d.id for d in row] for row in one.devices]),
            "names": np.array(one.axis_names),
            "two_ids": np.array([[d.id for d in row] for row in two]),
            "two_slices": np.array([[d.slice_index for d in row]
                                    for row in two]),
            "bad": np.array(bad)}


def ref_errors(cases: list) -> dict:
    """The message each reference call raises: ``("step", fields, n_dm,
    n_seq, dm_list)``, ``("mesh", n_dm, n_seq)``, ``("local", n_dm,
    n_trials)``, ``("init", fields)``."""
    import jax
    from srtb_tpu.config import Config
    from srtb_tpu.parallel import distributed as D
    from srtb_tpu.parallel import mesh as M
    from srtb_tpu.parallel.segment_dist import DistSegmentProcessor
    out = []
    for kind, *args in cases:
        try:
            if kind == "step":
                fields, n_dm, n_seq, dm_list = args
                DistSegmentProcessor(
                    Config(**fields), M.make_mesh(
                        n_dm, n_seq, devices=jax.devices()[:n_dm * n_seq]),
                    dm_list=dm_list)
            elif kind == "mesh":
                M.make_mesh(*args)
            elif kind == "local":
                D.process_local_dm_indices(M.make_mesh(args[0], 1),
                                           args[1])
            else:
                D.maybe_initialize_from_config(Config(**args[0]))
            out.append("")
        except Exception as e:  # the case's refusal, reported
            out.append(f"{type(e).__name__}: {e}")
    return {"messages": np.array(out)}


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


# a gated sink push gives up waiting for the engine after this long
SINK_GATE_TIMEOUT_S = 120.0


def gate_sink_pushes(pipe, levels: list, grace_s: float, total: int) -> None:
    """Hold the sink push of segment k until the engine has emitted
    segment k + 1 (its ladder's observation count, ``levels``, reaches
    k + 2, or ``total``), then ``grace_s`` more: the engine, which after
    that emit only queues the segment and finds its window full, waits
    on the sink however long it took to produce the segments.  So the
    sink pressure each emit sees depends on the order of events, not on
    how fast the host produces segments."""
    push = pipe._push_sinks
    pushes = [0]

    def gated(*args, **kwargs):
        want = min(pushes[0] + 2, total)
        pushes[0] += 1
        deadline = time.monotonic() + SINK_GATE_TIMEOUT_S
        while len(levels) < want and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(grace_s)
        return push(*args, **kwargs)
    pipe._push_sinks = gated


def resilience_run(pipeline_cls, cfg, counters_of, capture: bool = True,
                   source=None, max_segments=None, sink_gate=None,
                   **kwargs) -> dict:
    """One run of ``pipeline_cls(cfg, ...)``, with a capture sink or the
    configured writers: its captured decisions, the files under the
    output prefix's directory, its counters (``counters_of(pipe, name)``),
    the plans the healer installed, the degradation level of each emitted
    segment, and the name of the exception that ended it ("" when it
    completed).  ``sink_gate``: ``(grace_s, total segments)`` of
    :func:`gate_sink_pushes`."""
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
    if sink_gate is not None:
        gate_sink_pushes(pipe, levels, *sink_gate)
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
                       max_segments=None, sink_gate=None) -> dict:
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
                              source=source, max_segments=max_segments,
                              sink_gate=sink_gate)
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


# ------------------------------------------------- health (ROADMAP A9b)

def _canary_module(pkg: str):
    return importlib.import_module(f"{pkg}.quality.canary")


def _config(pkg: str, fields: dict):
    return importlib.import_module(f"{pkg}.config").Config(**fields)


def _host(x) -> np.ndarray:
    """numpy of a numpy array or a torch tensor."""
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)


def canary_delta(pkg: str, fields: dict, n: int, reserved: int) -> dict:
    """``CanaryController._build_delta`` of ``pkg`` for ``n`` samples and
    ``reserved`` reserved ones: the int16 delta and its t0."""
    C = _canary_module(pkg)
    c = C.CanaryController(_config(pkg, fields), n, reserved)
    return {"delta": _host(c._build_delta()).astype(np.int16),
            "t0": c.t0}


def canary_prepare_script(pkg: str, fields: dict, n: int, reserved: int,
                          steps: list) -> dict:
    """``prepare`` of one controller of ``pkg`` on each ``(abs_index,
    data)`` (uint8 arrays, one of them of the wrong size): the bytes
    returned, whether they are the input object, the marks (JSON) and
    ``canary_injected`` after each step."""
    C = _canary_module(pkg)
    M = _pkg(pkg, "metrics")
    M.metrics.reset()
    c = C.CanaryController(_config(pkg, fields), n, reserved)
    out, same, marks, injected = [], [], [], []
    for abs_index, data in steps:
        got, mark = c.prepare(abs_index, data)
        same.append(got is data)
        out.append(np.asarray(got, dtype=np.uint8))
        marks.append(json.dumps(mark, sort_keys=True))
        injected.append(M.metrics.get("canary_injected"))
    M.metrics.reset()
    return {"bytes": np.concatenate(out), "same": np.array(same),
            "marks": np.array(marks),
            "injected": np.array(injected, dtype=np.float64)}


def canary_gating(pkg: str, cases: list) -> dict:
    """``CanaryController.from_config`` of ``pkg`` on each config's
    fields: whether it arms."""
    C = _canary_module(pkg)
    return {"armed": np.array([
        C.CanaryController.from_config(_config(pkg, f)) is not None
        for f in cases])}


CANARY_GAUGES = ("canary_injected", "canary_checked", "canary_failed",
                 "canary_last_snr", "canary_expected_snr",
                 "canary_sensitivity_ratio", "detection_health_state")


def canary_check_script(pkg: str, fields: dict, peaks: list,
                        slo_fields: dict) -> dict:
    """``check`` of one controller of ``pkg`` over a sequence of S/N
    peak arrays, the SLO armed from ``slo_fields``: each verdict (JSON),
    the canary gauges, flat and ``stream``-labeled, after each check, the
    SLO's sensitivity state at the end and ``health()``'s detection
    section."""
    C = _canary_module(pkg)
    M = _pkg(pkg, "metrics")
    S = _pkg(pkg, "slo")
    T = _pkg(pkg, "telemetry")
    M.metrics.reset()
    S.reset()
    cfg = _config(pkg, fields)
    try:
        S.configure(_config(pkg, dict(fields, **slo_fields)))
        c = C.CanaryController.from_config(cfg, n_samples=1 << 12)
        verdicts, gauges = [], []
        lbl = {"stream": cfg.stream_name} if cfg.stream_name else None
        for i, p in enumerate(peaks):
            verdicts.append(json.dumps(c.check(2 * i + 1, np.asarray(p)),
                                       sort_keys=True))
            gauges.append([M.metrics.get(g) for g in CANARY_GAUGES]
                          + [M.metrics.get(g, labels=lbl)
                             for g in CANARY_GAUGES])
        rep = S.evaluate() or {}
        M.metrics.add("segments")
        T.mark_segment(None)  # health() reports past its idle start
        health = T.health(3600.0)
        return {"verdicts": np.array(verdicts),
                "gauges": np.array(gauges, dtype=np.float64),
                "slo": json.dumps(rep, sort_keys=True),
                "detection": json.dumps(health.get("detection"),
                                        sort_keys=True),
                "ok": bool(health["ok"])}
    finally:
        S.reset()
        M.metrics.reset()


def detection_health_script(pkg: str, script: list) -> dict:
    """``health()`` of ``pkg`` from a fresh registry (SLO disarmed) after
    each step: ``("check", ok)`` sets what a canary check sets,
    ``("mark",)`` a drained segment."""
    T = _pkg(pkg, "telemetry")
    M = _pkg(pkg, "metrics")
    _pkg(pkg, "slo").reset()
    M.metrics.reset()
    T._ADMITTED_STREAMS.clear()
    reports = []
    for op in script:
        if op[0] == "check":
            M.metrics.add("canary_checked")
            if not op[1]:
                M.metrics.add("canary_failed")
            M.metrics.set("canary_last_snr", 12.3456 if op[1] else 2.5)
            M.metrics.set("canary_expected_snr", 12.3456)
            M.metrics.set("canary_sensitivity_ratio",
                          1.0 if op[1] else 2.5 / 12.3456)
            M.metrics.set("detection_health_state", 0 if op[1] else 1)
        elif op[0] == "mark":
            M.metrics.add("segments")
            T.mark_segment(None)
        rep = T.health(3600.0)
        rep.pop("last_segment_age_s", None)
        reports.append(json.dumps(rep, sort_keys=True))
    M.metrics.reset()
    return {"reports": np.array(reports)}


HEALTH_COUNTERS = CANARY_GAUGES + (
    "plan_demotions", "device_reinits", "watchdog_requeues",
    "segments_dropped", "incident_bundles", "incidents_suppressed",
    "incident_dump_failures", "signals", "segments")


class WedgedSink:
    """A sink whose first push blocks until released (a disk that stopped
    answering)."""

    def __init__(self):
        import threading
        self.release = threading.Event()

    def push(self, work, positive):
        self.release.wait(30.0)


def _wedge_chain(pkg: str, pipe) -> None:
    """Make every dispatched segment of ``pipe`` never become ready (a
    wedged card): the reference's readiness probe, the port's event."""
    if pkg == "srtb_tpu":
        pipe._result_ready = lambda det_res: False
        return

    class NeverReady:
        def query(self):
            return False

        def synchronize(self):
            raise AssertionError("a wedged segment's results were read")
    to_host = pipe._to_host
    pipe._to_host = lambda dets: (to_host(dets)[0], NeverReady())


def _bundles(directory: str) -> dict:
    """Each incident bundle under ``directory``: its name, files,
    ``incident.json`` (less its wall time and pid), ``plan.json`` and
    ``extra.json``."""
    out = {}
    if not directory or not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        d = os.path.join(directory, name)
        rec = {"files": sorted(os.listdir(d))}
        for f in ("incident.json", "plan.json", "extra.json"):
            p = os.path.join(d, f)
            if os.path.exists(p):
                with open(p) as fh:
                    rec[f] = json.load(fh)
        inc = rec.get("incident.json")
        if inc is not None:
            inc.pop("ts")
            inc.pop("pid")
            inc["trace_id"] = inc["trace_id"] > 0
        out[name] = rec
    return out


def health_run(pkg: str, fields: dict, max_segments=None,
               source_fields: dict | None = None, wedge: str = "",
               chain_log: list | None = None) -> dict:
    """One ``Pipeline`` run of ``pkg`` on ``fields`` from a fresh registry,
    SLO and flight recorder: the exception that ended it (its class name,
    "" when it completed), its segment and signal counts, the journal's
    span fields that are not times (JSON lines: segment, dump, detections
    and the ``canary`` extra), the run manifest's canary records, the
    SHA-256 of the write-all file, the health counters, ``health()``'s
    detection section and the incident bundles (:func:`_bundles`, JSON).
    ``source_fields`` makes the source a file reader of that config (a
    live source's stand-in: ``fields`` has no input file).  ``wedge``:
    "chain" makes every dispatch never ready, "sink" replaces the sinks by
    a :class:`WedgedSink`.  ``chain_log`` (the port only) receives the
    bytes each chain reads."""
    import hashlib
    R = importlib.import_module(f"{pkg}.pipeline.runtime")
    T = _pkg(pkg, "telemetry")
    M = _pkg(pkg, "metrics")
    E = _pkg(pkg, "events")
    I = _pkg(pkg, "incidents")
    M.metrics.reset()
    _pkg(pkg, "slo").reset()
    E.configure(False)
    I.IncidentRecorder._last_dump_by_dir.clear()
    cfg = _config(pkg, fields)
    kwargs = {"device": "cpu"} if pkg == "srtb_tpu_torch" else {}
    if source_fields is not None:
        kwargs["source"] = importlib.import_module(
            f"{pkg}.io.file_input").make_file_source(
                _config(pkg, source_fields))
    sink = None
    if wedge == "sink":
        sink = WedgedSink()
        kwargs["sinks"] = [sink]
    restore = None
    if chain_log is not None:
        S = importlib.import_module(f"{pkg}.pipeline.segment")
        chain = S.SegmentProcessor._chain

        def logged(self, raw):
            chain_log.append(raw.cpu().numpy().copy())
            return chain(self, raw)
        S.SegmentProcessor._chain = logged

        def restore():
            S.SegmentProcessor._chain = chain
    error = ""
    try:
        pipe = R.Pipeline(cfg, **kwargs)
        if wedge == "chain":
            _wedge_chain(pkg, pipe)
        with pipe:
            stats = pipe.run(max_segments)
    except Exception as e:  # noqa: BLE001 - reported by name
        error = type(e).__name__
        stats = None
    finally:
        if sink is not None:
            sink.release.set()
        if restore is not None:
            restore()
    spans = []
    jp = cfg.telemetry_journal_path
    if jp and os.path.exists(jp):
        with open(jp) as f:
            for line in f:
                rec = json.loads(line)
                spans.append(json.dumps(
                    {k: rec.get(k) for k in ("segment", "dump",
                                             "detections", "canary")},
                    sort_keys=True))
    canary_recs = []
    if cfg.run_manifest_path and os.path.exists(cfg.run_manifest_path):
        with open(cfg.run_manifest_path, "rb") as f:
            for line in f.read().splitlines():
                rec = json.loads(line)
                if rec.get("t") == "canary":
                    canary_recs.append(json.dumps(rec, sort_keys=True))
    digest = ""
    wa = cfg.baseband_output_file_prefix + "stream0.bin"
    if cfg.baseband_write_all and os.path.exists(wa):
        with open(wa, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    health = T.health(3600.0)
    prefix = cfg.baseband_output_file_prefix
    files = sorted(f for f in os.listdir(os.path.dirname(prefix))
                   if f.startswith(os.path.basename(prefix))) \
        if prefix and os.path.isdir(os.path.dirname(prefix)) else []
    out = {"error": error, "files": np.array(files or [""]),
           "segments": stats.segments if stats is not None else -1,
           "signals": stats.signals if stats is not None else -1,
           "spans": np.array(spans or [""]),
           "manifest": np.array(canary_recs or [""]),
           "write_all": digest,
           "counters": np.array([M.metrics.get(k) for k in HEALTH_COUNTERS],
                                dtype=np.float64),
           "detection": json.dumps(health.get("detection"),
                                   sort_keys=True),
           "bundles": json.dumps(_bundles(cfg.incident_dir),
                                 sort_keys=True)}
    M.metrics.reset()
    E.configure(False)
    return out


def plant_manifest_loss(pkg: str, manifest_path: str) -> None:
    """A run directory whose manifest committed segment 0's artifact and
    sealed a checkpoint past it, and whose artifact is then gone: the
    next recovery flags the loss."""
    MF = importlib.import_module(f"{pkg}.io.manifest")
    d = os.path.dirname(manifest_path)
    art = os.path.join(d, "out_lost.npy")
    with open(art, "wb") as f:
        f.write(b"lost bytes")
    m = MF.RunManifest(manifest_path)
    key = (0, 0, "0:WriteSignalSink")
    m.intent(key, art)
    m.commit(key, art, 10)
    m.sink_done(key)
    m.checkpoint(1, 4096)
    m.close()
    os.unlink(art)


def manifest_loss_run(pkg: str, fields: dict) -> dict:
    """:func:`health_run` of ``pkg`` on a run directory with a planted
    loss (:func:`plant_manifest_loss`)."""
    plant_manifest_loss(pkg, fields["run_manifest_path"])
    return health_run(pkg, fields)


def ref_canary_prepare_of_file(fields: dict, path: str, stride: int,
                               n_segments: int, base: int = 0) -> dict:
    """The reference's ``prepare`` of each segment of the file at
    ``path`` (segment i: ``stride * i`` on, ``baseband_input_count``
    bytes; absolute index ``base + i``): the bytes its chain would
    read."""
    from srtb_tpu.config import Config
    from srtb_tpu.ops import dedisperse as dd
    from srtb_tpu.quality.canary import CanaryController
    cfg = Config(**fields)
    n = cfg.baseband_input_count
    c = CanaryController.from_config(
        cfg, n_samples=n, reserved_samples=dd.nsamps_reserved(cfg))
    raw = np.fromfile(path, dtype=np.uint8)
    out = []
    for i in range(n_segments):
        seg = raw[i * stride:i * stride + n]
        if len(seg) < n:  # the reader's zero-padded last segment
            seg = np.concatenate([seg, np.zeros(n - len(seg), np.uint8)])
        out.append(c.prepare(base + i, seg)[0])
    return {"bytes": np.stack(out)}


def incident_recorder_script(pkg: str, directory: str, max_bundles: int,
                             min_interval_s: float, steps: list) -> dict:
    """An ``IncidentRecorder`` of ``pkg`` on a fake clock over
    ``directory`` (a ``*.srtb_tmp`` leftover planted there first):
    ``("dump", kind, reason)``, ``("tick", seconds)``, ``("clear",)``
    (the operator empties the directory) and ``("break",)`` (the
    directory becomes a file: every later dump fails).  Returns each
    dump's result (its name, or "" when suppressed or failed), the
    counters after each step and the directory listing at the end."""
    import shutil
    I = _pkg(pkg, "incidents")
    M = _pkg(pkg, "metrics")
    E = _pkg(pkg, "events")
    M.metrics.reset()
    I.IncidentRecorder._last_dump_by_dir.clear()
    # a fresh flight recorder, whatever an earlier test in this process
    # left armed or disarmed; the caller's is given back at the end
    saved_hub = E.hub
    E.configure(False)
    E.configure(True)
    os.makedirs(os.path.join(directory, "incident_007_x.srtb_tmp"))
    clock = FakeClock()
    results, counters = [], []
    with fake_time(I, clock):
        rec = I.IncidentRecorder(directory, max_bundles=max_bundles,
                                 min_interval_s=min_interval_s)
        swept = sorted(os.listdir(directory))
        for op in steps:
            if op[0] == "dump":
                got = rec.dump(op[1], reason=op[2], extra={"step": op[1]})
                results.append(os.path.basename(got) if got else "")
            elif op[0] == "tick":
                clock.advance(op[1])
            elif op[0] == "clear":
                for name in os.listdir(directory):
                    shutil.rmtree(os.path.join(directory, name))
            elif op[0] == "break":
                shutil.rmtree(directory)
                with open(directory, "w") as f:
                    f.write("not a directory\n")
            counters.append([M.metrics.get(k) for k in (
                "incident_bundles", "incidents_suppressed",
                "incident_dump_failures")])
    listing = (sorted(os.listdir(directory))
               if os.path.isdir(directory) else [])
    evs = [e["info"] for e in (E.hub.dump() if E.hub else [])
           if e["type"] == "incident"]
    E.hub = saved_hub
    M.metrics.reset()
    return {"results": np.array(results),
            "counters": np.array(counters, dtype=np.float64),
            "swept": np.array(swept or [""]),
            "listing": np.array(listing or [""]),
            "events": np.array(evs or [""])}


def report_outputs(pkg: str, journals: list, event_dumps: list,
                   bin_s: float) -> dict:
    """``pkg``'s ``telemetry_report`` and ``quality_report`` (md and json)
    of each journal and its ``trace_export`` (``--validate`` and the
    written document, its ``otherData.source`` removed) of each events
    dump or bundle directory: everything each prints and writes."""
    import contextlib
    import io
    import tempfile
    tools = {name: importlib.import_module(f"{pkg}.tools.{name}")
             for name in ("telemetry_report", "quality_report",
                          "trace_export")}

    def printed(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return f"rc={rc}\n{buf.getvalue()}"
    out = {}
    for i, j in enumerate(journals):
        for fmt in ("md", "json"):
            out[f"telemetry/{i}/{fmt}"] = printed(
                tools["telemetry_report"].main,
                [j, "--format", fmt, "--bin", str(bin_s)])
            out[f"quality/{i}/{fmt}"] = printed(
                tools["quality_report"].main, [j, "--format", fmt])
    for i, e in enumerate(event_dumps):
        out[f"trace/{i}/validate"] = printed(tools["trace_export"].main,
                                             [e, "--validate"])
        with tempfile.TemporaryDirectory() as d:
            dest = os.path.join(d, "trace.json")
            printed(tools["trace_export"].main, [e, "--out", dest])
            with open(dest) as f:
                doc = json.load(f)
        doc["otherData"].pop("source")
        out[f"trace/{i}/doc"] = json.dumps(doc, sort_keys=True)
    return out


# ------------------------------------------------------------ perf tools
# The JAX package's perf statistics, ledger, report and gate, and its
# plan signature, for tests/test_torch_perf.py.

def json_call(spec: str, *args, **kwargs) -> dict:
    """``spec``'s function on the arguments; its result as JSON."""
    return {"json": json.dumps(_resolve(spec)(*args, **kwargs),
                               sort_keys=True, default=str)}


def tool_output(module: str, argv: list) -> dict:
    """A tool's ``main(argv)``: its exit code and what it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(module).main(list(argv))
    return {"out": f"rc={rc}\n{buf.getvalue()}"}


def plan_signature(fields: dict, env: dict | None = None,
                   staged: bool | None = None) -> dict:
    """The reference processor's ``plan_signature()`` for a config, built
    under the environment ``env``, and its ``_TRACE_CFG_KEYS``."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.segment import SegmentProcessor
    with environ(env):
        sig = SegmentProcessor(Config(**fields), staged=staged
                               ).plan_signature()
    return {"json": sig,
            "trace_cfg_keys": np.array(SegmentProcessor._TRACE_CFG_KEYS)}



# ------------------------------------------------------------------ A9d
# The JAX package's threaded engine, sanitizer, float64 oracle and live
# tools, for tests/test_torch_threaded.py, test_torch_sanitizer.py,
# test_torch_aot.py and test_torch_live_tools.py.

def ref_threaded_run(fields: dict, capture: bool = True,
                     max_segments=None, journal: bool = False) -> dict:
    """:func:`resilience_run` on the reference's ``ThreadedPipeline``;
    with ``journal`` the spans of ``telemetry_journal_path`` too (their
    keys, a span a row)."""
    from srtb_tpu.config import Config
    from srtb_tpu.pipeline.runtime import ThreadedPipeline
    from srtb_tpu.utils.metrics import metrics
    metrics.reset()
    try:
        res = resilience_run(ThreadedPipeline, Config(**fields),
                             lambda _pipe, k: metrics.get(k), capture,
                             max_segments=max_segments)
    finally:
        metrics.reset()
    if journal:
        with open(fields["telemetry_journal_path"]) as f:
            spans = [json.loads(line) for line in f]
        res["span_keys"] = json.dumps([sorted(s) for s in spans])
    return res


def sanitizer_messages(cases: list) -> dict:
    """The reference sanitizer's verdict on each case: ``("finite", tag,
    values)`` or ``("contract", tag, shape, dtype, kwargs)`` on a device
    array; the message of the error raised ("" when none)."""
    import jax.numpy as jnp
    from srtb_tpu.analysis import sanitizer as S
    out = {}
    for i, case in enumerate(cases):
        try:
            if case[0] == "finite":
                S.check_finite(case[1], jnp.asarray(np.array(case[2])))
            else:
                _kind, tag, shape, dtype, kwargs = case
                S.check_contract(tag, jnp.zeros(shape, dtype), **kwargs)
            out[str(i)] = ""
        except S.SanitizerError as e:
            out[str(i)] = str(e)
    return out


def oracle_outputs(raws: dict, nbits: dict, chain: dict) -> dict:
    """``tests/oracle_utils.py`` on the given bytes: ``oracle_unpack`` and
    ``oracle_deinterleave`` of each format's bytes, and
    ``oracle_stream_chain`` of ``chain["samples"]`` under the config of
    ``chain["fields"]``."""
    import oracle_utils as OU
    from srtb_tpu.config import Config
    out = {}
    for name, raw in raws.items():
        bits = nbits[name]
        if name == "simple":
            out[f"unpack/{bits}"] = OU.oracle_unpack(raw, bits)
        for s, x in enumerate(OU.oracle_deinterleave(raw, name, bits)):
            out[f"deinterleave/{name}/{s}"] = x
    wf, ts, nzap = OU.oracle_stream_chain(chain["samples"],
                                          Config(**chain["fields"]))
    out.update({"chain/wf": wf, "chain/ts": ts, "chain/nzap": nzap})
    return out


def tool_keys(n_packets: int) -> dict:
    """The reference's live tools' JSON: ``udp_soak.run_soak`` through its
    Python receiver, and the e2e harness at 2^14 for a second, each as
    its sorted keys (and the soak's fixed fields)."""
    import contextlib
    import io
    from srtb_tpu.tools import e2e_live, udp_soak
    soak = udp_soak.run_soak(n_packets, "python", port=free_udp_port())
    buf = io.StringIO()
    with tempfile_dir() as d, contextlib.redirect_stdout(buf):
        rc = e2e_live.main(["--seconds", "1", "--rate_x", "0.05",
                            "--log2n", "14", "--log2chan", "5", "--port",
                            str(free_udp_port()), "--prefix",
                            f"{d}/out_", "--max_segments", "2"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"soak_keys": json.dumps(sorted(soak)),
            "soak_required_gbps": soak["required_gbps"],
            "e2e_rc": rc, "e2e_keys": json.dumps(sorted(line))}


def lint_findings(dirs: dict, rules: list, pkg: str = "srtb_tpu") -> dict:
    """``<pkg>.analysis.lint.run`` on each fixture directory: the findings
    of ``rules`` as JSON ``[rule, line, col, message, context, rel]``.
    The port's tests call it with ``pkg="srtb_tpu_torch"`` in their own
    process."""
    lint = importlib.import_module(f"{pkg}.analysis.lint")
    return {name: json.dumps([[f.rule, f.line, f.col, f.message, f.context,
                               f.rel] for f in lint.run([d])
                              if f.rule in rules])
            for name, d in dirs.items()}


def _quiet_main(main, argv: list) -> int:
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def lint_cli_script(src: str, new_file: str, new_text: str,
                    pkg: str = "srtb_tpu") -> dict:
    """The reference's baseline and CLI workflow (``tests/test_lint.py``
    ``TestBaselineAndCli``) on the fixture tree ``src``: the exit codes of
    new finding, write, accepted, note kept across a rewrite, a second
    file's new finding; the baseline written; the stale key reported for
    an entry that no longer fires; ``--format json``'s new rules; the
    ``--list-rules`` ids."""
    import contextlib
    import io
    lint = importlib.import_module(f"{pkg}.analysis.lint")
    core = importlib.import_module(f"{pkg}.analysis.core")
    bl = os.path.join(os.path.dirname(src), "baseline.json")
    rcs = [_quiet_main(lint.main, [src, "--baseline", bl]),
           _quiet_main(lint.main, [src, "--baseline", bl,
                                   "--write-baseline"]),
           _quiet_main(lint.main, [src, "--baseline", bl])]
    with open(bl) as f:
        data = json.load(f)
    key = sorted(data["entries"])[0]
    data["entries"][key]["note"] = "accepted: a note"
    with open(bl, "w") as f:
        json.dump(data, f)
    rcs.append(_quiet_main(lint.main, [src, "--baseline", bl,
                                       "--write-baseline"]))
    with open(bl) as f:
        kept = json.load(f)
    findings = lint.run([src])
    base = core.Baseline.from_findings(findings)
    base.entries["gone::rule::f::x"] = {"count": 1}
    new, accepted, stale = base.filter(findings)
    with open(os.path.join(src, new_file), "w") as f:
        f.write(new_text)
    rcs.append(_quiet_main(lint.main, [src, "--baseline", bl]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lint.main([src, "--no-baseline", "--format", "json"])
    doc = json.loads(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_list = lint.main(["--list-rules"])
    return {"rcs": np.array(rcs + [rc_list]),
            "baseline": json.dumps(kept, sort_keys=True),
            "filter": json.dumps([len(new), len(accepted), stale]),
            "json_new": json.dumps([[f["rule"], f["rel"], f["line"]]
                                    for f in doc["new"]]),
            "list_rules": json.dumps(sorted(
                line.split(":", 1)[0]
                for line in buf.getvalue().splitlines()))}


def lint_baseline_rcs(src: str, pkg: str = "srtb_tpu") -> dict:
    """``tests/test_tsan.py::test_baseline_accepts_rule`` on ``src``: the
    exit codes of new finding, write, accepted."""
    lint = importlib.import_module(f"{pkg}.analysis.lint")
    bl = os.path.join(os.path.dirname(src), "baseline.json")
    return {"rcs": np.array([
        _quiet_main(lint.main, [src, "--baseline", bl]),
        _quiet_main(lint.main, [src, "--baseline", bl, "--write-baseline"]),
        _quiet_main(lint.main, [src, "--baseline", bl])])}


def _obs_span(ts, seg, stream="s0", device="dev0", plan="p1", **extra):
    rec = {"type": "segment_span", "ts": float(ts), "segment": int(seg),
           "stream": stream, "device": device, "active_plan": plan,
           "samples": 4096,
           "stages_ms": {"ingest": 1.0, "dispatch": 2.0, "sink": 0.5}}
    rec.update(extra)
    return rec


def _obs_journal(path, records) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def obs_digest_script(pkg: str = "srtb_tpu") -> dict:
    """``QuantileDigest`` on the seeded data of ``tests/test_obs.py``:
    quantiles of 20000 lognormal values (seed 42), the three-way merge
    against the whole (exponential, seed 7), the JSON round trip and the
    guards (the exception raised by each, by name)."""
    import math
    D = importlib.import_module(f"{pkg}.obs.digest")
    rng = np.random.default_rng(42)
    vals = rng.lognormal(mean=0.0, sigma=1.0, size=20000)
    d = D.QuantileDigest(alpha=0.01)
    for v in vals:
        d.add(float(v))
    qs = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)
    rng = np.random.default_rng(7)
    exp = rng.exponential(scale=3.0, size=3000)
    whole = D.QuantileDigest()
    parts = [D.QuantileDigest() for _ in range(3)]
    for i, v in enumerate(exp):
        whole.add(float(v))
        parts[i % 3].add(float(v))
    merged = parts[0]
    merged.merge(parts[1])
    merged.merge(parts[2])
    small = D.QuantileDigest()
    for v in (0.0, 1e-12, 0.5, 100.0):
        small.add(v)
    back = D.QuantileDigest.from_dict(
        json.loads(json.dumps(small.to_dict(), sort_keys=True)))
    errors = []
    for fn in (lambda: small.add(-1.0), lambda: small.add(float("nan")),
               lambda: D.QuantileDigest(alpha=0.01).merge(
                   D.QuantileDigest(alpha=0.02)),
               lambda: D.QuantileDigest(alpha=1.5)):
        try:
            fn()
            errors.append("")
        except ValueError as e:
            errors.append(type(e).__name__)
    return {"lognormal_q": np.array([d.quantile(q) for q in qs]),
            "lognormal": json.dumps(d.to_dict(), sort_keys=True),
            "merged": json.dumps(merged.to_dict(), sort_keys=True),
            "whole": json.dumps(whole.to_dict(), sort_keys=True),
            "merged_q": np.array([merged.quantile(q)
                                  for q in (0.5, 0.95, 0.99)]),
            "round_trip": json.dumps([back.to_dict(), small.to_dict(),
                                      back.quantile(0.99)],
                                     sort_keys=True),
            "errors": np.array(errors),
            "empty_is_nan": math.isnan(D.QuantileDigest().quantile(0.5))}


def obs_store_script(tmp: str, pkg: str = "srtb_tpu") -> dict:
    """``RollupStore`` as ``tests/test_obs.py`` drives it: last-wins, two
    compactions byte for byte, a re-appended duplicate, the unkeyed row's
    exception, retention's drops and the keys left."""
    S = importlib.import_module(f"{pkg}.obs.store")
    store = S.RollupStore(os.path.join(tmp, "store"))
    store.append_many([
        {"k": "m:1:a", "minute": 1, "segments": 2},
        {"k": "m:1:a", "minute": 1, "segments": 5},
        {"k": "m:2:a", "minute": 2, "segments": 1},
        {"k": "d:stage:x", "digest": {"count": 3}}])
    latest = store.latest()["m:1:a"]["segments"]
    seg_dir = os.path.join(tmp, "store", "segments")

    def seg_bytes():
        out = {}
        for n in sorted(os.listdir(seg_dir)):
            with open(os.path.join(seg_dir, n)) as f:
                out[n] = f.read()
        return out
    r1 = store.compact()
    b1 = seg_bytes()
    r2 = store.compact()
    b2 = seg_bytes()
    store.append({"k": "m:2:a", "minute": 2, "segments": 1})
    store.compact()
    b3 = seg_bytes()
    try:
        store.append({"minute": 3})
        unkeyed = ""
    except ValueError as e:
        unkeyed = type(e).__name__
    ret = S.RollupStore(os.path.join(tmp, "s"), retention_minutes=10)
    ret.append_many([{"k": f"m:{m}", "minute": m} for m in (0, 5, 90, 100)]
                    + [{"k": "d:meta"}])
    rep = ret.compact()
    return {"latest": latest, "compact": json.dumps([r1, r2, rep]),
            "bytes": json.dumps([b1, b2 == b1, b3 == b1], sort_keys=True),
            "after": store.latest()["m:1:a"]["segments"],
            "unkeyed": unkeyed,
            "retained": json.dumps(sorted(ret.latest()))}


def obs_aggregator_script(tmp: str, pkg: str = "srtb_tpu") -> dict:
    """The ``Aggregator`` scenarios of ``tests/test_obs.py``: rollup rows
    and digests of five spans; resume by offset over a torn tail; a torn
    then whole rotated ``.gz``; the active arm's rotation; an event dump
    read twice.  Rows as canonical JSON, poll counts in order."""
    import gzip
    R = importlib.import_module(f"{pkg}.obs.rollup")
    S = importlib.import_module(f"{pkg}.obs.store")
    out = {}
    d = os.path.join(tmp, "counters")
    os.makedirs(d)
    jp = os.path.join(d, "j.jsonl")
    _obs_journal(jp, [_obs_span(60.0 + i, i,
                                segments_dropped=(1 if i >= 3 else 0),
                                detections=1, device_ms=2.0, batch_size=2)
                      for i in range(5)])
    store = S.RollupStore(os.path.join(d, "store"))
    agg = R.Aggregator(store, journals=[jp])
    polls = [agg.poll()["spans"]]
    agg.flush()
    out["counters_rows"] = json.dumps(store.latest(), sort_keys=True)
    out["counters_plans"] = json.dumps([agg.plans(),
                                        agg.segment_seconds("p1"),
                                        agg.rollup_median_s("p1")])
    d = os.path.join(tmp, "resume")
    os.makedirs(d)
    jp = os.path.join(d, "j.jsonl")
    _obs_journal(jp, [_obs_span(60.0 + i, i) for i in range(4)])
    sd = os.path.join(d, "store")
    agg = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls.append(agg.poll()["spans"])
    agg.flush()
    with open(jp, "a") as f:
        f.write(json.dumps(_obs_span(64.0, 4)) + "\n")
        f.write('{"type": "segment_span", "ts": 65')
    agg2 = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls.append(agg2.poll()["spans"])
    agg2.flush()
    with open(jp, "a") as f:
        f.write('.0, "segment": 5, "stream": "s0", '
                '"stages_ms": {"ingest": 1.0}}\n')
    agg3 = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls += [agg3.poll()["spans"], agg3.poll()["spans"]]
    d = os.path.join(tmp, "gz")
    os.makedirs(d)
    jp = os.path.join(d, "j.jsonl")
    payload = "".join(json.dumps(_obs_span(60.0 + i, i)) + "\n"
                      for i in range(20)).encode()
    whole = gzip.compress(payload, mtime=0)
    with open(jp + ".1.gz", "wb") as f:
        f.write(whole[:len(whole) * 2 // 3])
    _obs_journal(jp, [_obs_span(100.0, 20)])
    sd = os.path.join(d, "store")
    agg = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls.append(agg.poll()["spans"])
    agg.flush()
    with open(jp + ".1.gz", "wb") as f:
        f.write(whole)
    agg2 = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls.append(agg2.poll()["spans"])
    agg2.flush()
    polls.append(R.Aggregator(S.RollupStore(sd),
                              journals=[jp]).poll()["spans"])
    d = os.path.join(tmp, "rotate")
    os.makedirs(d)
    jp = os.path.join(d, "j.jsonl")
    _obs_journal(jp, [_obs_span(60.0 + i, i) for i in range(3)])
    sd = os.path.join(d, "store")
    agg = R.Aggregator(S.RollupStore(sd), journals=[jp])
    polls.append(agg.poll()["spans"])
    agg.flush()
    with open(jp, "rb") as f:
        old = f.read()
    with open(jp + ".1.gz", "wb") as f:
        f.write(gzip.compress(old, mtime=0))
    _obs_journal(jp, [_obs_span(120.0 + i, 3 + i) for i in range(2)])
    polls.append(R.Aggregator(S.RollupStore(sd),
                              journals=[jp]).poll()["spans"])
    d = os.path.join(tmp, "events")
    os.makedirs(d)
    ev = os.path.join(d, "events.jsonl")
    with open(ev, "w") as f:
        for r in ({"t": 1.5, "ts": 61.5, "type": "fleet.migrate",
                   "stream": "s0", "seg": 3, "info": "dev0->dev1",
                   "thread": "ctl"},
                  {"t": 2.5, "ts": 62.5, "type": "stage.sink",
                   "stream": "s0", "seg": 3, "thread": "sink"}):
            f.write(json.dumps(r) + "\n")
    store = S.RollupStore(os.path.join(d, "store"))
    agg = R.Aggregator(store, journals=[], events_dumps=[ev])
    polls += [agg.poll()["events"], agg.poll()["events"]]
    agg.flush()
    out["events_rows"] = json.dumps(store.latest(), sort_keys=True)
    out["polls"] = np.array(polls)
    return out


def obs_trace_join_script(tmp: str, pkg: str = "srtb_tpu") -> dict:
    """``trace_join`` on the journal and event dump of
    ``tests/test_obs.py`` (six segments, three a device, a migration):
    the document (its ``source`` label left out), ``validate``'s
    problems, and ``main``'s exit code and event count."""
    TJ = importlib.import_module(f"{pkg}.obs.trace_join")
    TE = importlib.import_module(f"{pkg}.tools.trace_export")
    jp = os.path.join(tmp, "j.jsonl")
    _obs_journal(jp, [_obs_span(60.0 + i, i,
                                device=("dev0" if i < 3 else "dev1"))
                      for i in range(6)])
    ev = os.path.join(tmp, "events.jsonl")
    with open(ev, "w") as f:
        for i in range(6):
            f.write(json.dumps(
                {"t": 10.0 + i, "ts": 60.0 + i, "type": "stage.dispatch",
                 "trace": i + 1, "stream": "s0", "seg": i,
                 "dur_ms": 2.0, "thread": "eng"}) + "\n")
            f.write(json.dumps(
                {"t": 10.4 + i, "ts": 60.4 + i, "type": "stage.sink",
                 "trace": i + 1, "stream": "s0", "seg": i,
                 "dur_ms": 0.5, "thread": "sink"}) + "\n")
        f.write(json.dumps(
            {"t": 12.5, "ts": 62.5, "type": "fleet.migrate", "trace": 0,
             "stream": "s0", "seg": -1, "info": "dev0->dev1",
             "thread": "ctl"}) + "\n")
    doc = TJ.join([ev], [jp])
    doc["otherData"].pop("source")
    out_path = os.path.join(tmp, "trace.json")
    rc = _quiet_main(TJ.main, [ev, "--journals", jp, "--out", out_path])
    with open(out_path) as f:
        n_cli = len(json.load(f)["traceEvents"])
    empty = os.path.join(tmp, "empty.jsonl")
    open(empty, "w").close()
    return {"doc": json.dumps(doc, sort_keys=True),
            "problems": json.dumps(TE.validate(doc)),
            "lane_base": TJ.LANE_FLOW_BASE,
            "cli": np.array([rc, n_cli,
                             _quiet_main(TJ.main, [empty, "--out",
                                                   out_path])])}


def obs_regression_script(tmp: str, pkg: str = "srtb_tpu") -> dict:
    """``RegressionWatch`` as ``tests/test_obs.py`` drives it: a seeded
    baseline in the ledger, a slow side that trips once and latches, a
    clean side that does not, and the verdicts without enough samples."""
    RW = importlib.import_module(f"{pkg}.obs.regression")
    PL = importlib.import_module(f"{pkg}.utils.perf_ledger")
    ledger = os.path.join(tmp, "ledger.jsonl")
    rng = np.random.default_rng(0)
    base = (0.010 + rng.normal(0, 2e-4, 24)).tolist()
    PL.PerfLedger(ledger).append(PL.make_record(
        "test", 0.01, "s/segment", plan="p1", samples_s=base,
        host_fp="", git_sha_value=""))
    inc = os.path.join(tmp, "incidents")
    watch = RW.RegressionWatch(ledger, incident_dir=inc, host_fp="")
    slow = (0.020 + rng.normal(0, 2e-4, 24)).tolist()
    v1 = watch.check("p1", slow)
    n1 = len(RW._bundles(inc))
    v2 = watch.check("p1", slow)
    n2 = len(RW._bundles(inc))
    clean = (0.010 + rng.normal(0, 2e-4, 24)).tolist()
    inc2 = os.path.join(tmp, "inc2")
    vc = RW.RegressionWatch(ledger, incident_dir=inc2,
                            host_fp="").check("p1", clean)
    thin = RW.RegressionWatch(os.path.join(tmp, "none.jsonl"), host_fp="")
    t1 = thin.check("p1", [0.01] * 3)
    t2 = thin.check("p1", [0.01] * 24)
    return {"verdicts": json.dumps([v1, v2, vc, t1, t2], sort_keys=True),
            "bundles": np.array([n1, n2, len(RW._bundles(inc2))])}


def tempfile_dir():
    import tempfile
    return tempfile.TemporaryDirectory()

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


# ------------------------------------------------- the fleet (A8b)
# Scripted runners that take the package's name, so that one script drives
# the JAX package's fleet (in this runner's interpreter) and the port's (in
# the pytest process, on the CPU).


def _fleet_mods(pkg: str):
    imp = importlib.import_module
    return (imp(f"{pkg}.config").Config, imp(f"{pkg}.pipeline.fleet"),
            imp(f"{pkg}.pipeline.runtime").Pipeline,
            imp(f"{pkg}.utils.metrics").metrics)


def _cpu_kw(pkg: str) -> dict:
    """The port's entry points run on the card unless asked for the CPU."""
    return {"device": "cpu"} if pkg == "srtb_tpu_torch" else {}


class DecisionCap:
    """Decision-capturing sink (the reference's fleet tests' ``_Cap``)."""

    def __init__(self):
        self.out = []

    def push(self, work, positive):
        det = work.detect
        self.out.append((np.asarray(det.signal_counts).copy(),
                         np.asarray(det.zero_count).copy(),
                         np.asarray(det.time_series).copy(),
                         bool(positive)))


def _decisions(out: list) -> dict:
    if not out:
        return {"n": 0}
    return {"n": len(out),
            "signal_counts": np.stack([o[0] for o in out]),
            "zero_count": np.stack([o[1] for o in out]),
            "time_series": np.stack([o[2] for o in out]),
            "positive": np.array([o[3] for o in out])}


def _journal_summary(path: str) -> dict:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {"v": [int(r["v"]) for r in recs],
            "stream": [str(r.get("stream", "")) for r in recs],
            "device": [str(r.get("device", "")) for r in recs],
            "segment": [int(r["segment"]) for r in recs],
            "batch_size": [int(r.get("batch_size", 0)) for r in recs],
            "has_wait": [int("batch_wait_ms" in r) for r in recs],
            "plan_demotions": [int(r.get("plan_demotions", 0))
                               for r in recs]}


FLEET_COUNTERS = ("plan_demotions", "device_reinits", "device_drains",
                  "migrations", "batched_dispatches", "batched_segments",
                  "fleet_admitted", "fleet_queued", "fleet_rejected",
                  "fleet_readmitted", "fleet_plan_compiles",
                  "fleet_plan_cache_hits", "rolled_back_intents",
                  "ring_cold_dispatches", "segments_dropped")
FLEET_LABELED = ("plan_demotions", "device_reinits", "migrations",
                 "segments_dropped", "batched_segments", "segments")


def fleet_run(pkg: str, streams: dict, solo: bool = False,
              pool_halts: list | None = None, rolling: bool = False,
              pins: dict | None = None, burn: list | None = None,
              debris: dict | None = None, prom: list | None = None
              ) -> dict:
    """One fleet run of ``pkg``: ``streams`` maps a name to its config
    fields; each stream's decisions captured (and with ``solo`` its solo
    ``Pipeline`` run's first, each from a fresh registry).  ``pool_halts``
    schedules member i's virtual halt after K_i dispatches; ``rolling``
    queues a rolling restart before the run; ``pins`` a stream's
    ``pin_device``; ``burn`` names streams whose SLO verdict burns."""
    Config, F, Pipeline, metrics = _fleet_mods(pkg)
    kw = _cpu_kw(pkg)
    out: dict = {"solo": {}}
    for man_path, orphan in (debris or {}).values():
        # crash debris in a stream's manifest namespace: an uncommitted
        # intent and its orphaned artifact
        RunManifest = importlib.import_module(f"{pkg}.io.manifest"
                                              ).RunManifest
        m = RunManifest.open(man_path, fsync=False)
        m.intent((0, 0, "0:WriteSignalSink"), orphan)
        m.sync()
        m.close()
        with open(orphan, "wb") as f:
            f.write(b"orphan")
    if solo:
        for name, fields in streams.items():
            metrics.reset()
            cap = DecisionCap()
            sf = dict(fields, baseband_output_file_prefix=fields[
                "baseband_output_file_prefix"] + "solo_")
            sf.pop("telemetry_journal_path", None)
            with Pipeline(Config(**sf), sinks=[cap], **kw) as pipe:
                stats = pipe.run()
            out["solo"][name] = dict(_decisions(cap.out),
                                     segments=int(stats.segments))
    metrics.reset()
    if burn:
        slo = importlib.import_module(f"{pkg}.utils.slo")

        class _Burning:
            def evaluate(self):
                return {b: {"ok": False} for b in burn}

            def note_segment(self, *a, **k):
                pass

            note_dropped = note_canary = note_segment
        saved = slo.tracker
        slo.tracker = _Burning()
    caps = {name: DecisionCap() for name in streams}
    specs = [F.StreamSpec(name=name, cfg=Config(**fields),
                          sinks=[caps[name]],
                          pin_device=(pins or {}).get(name))
             for name, fields in streams.items()]
    try:
        fleet = F.StreamFleet(specs, **kw)
        for i, k in enumerate(pool_halts or ()):
            fleet.pool.schedule_halt(i, after_dispatches=k)
        if rolling:
            fleet.rolling_restart()
        res = fleet.run()
        out["pool_compiles"] = fleet.pool.compiles
        out["pool_size"] = len(fleet.pool)
        out["pool_states"] = [d.state for d in fleet.pool.devices]
        out["compiles"] = fleet.plans.compiles
        out["hits"] = fleet.plans.hits
        fleet.close()
    finally:
        if burn:
            slo.tracker = saved
    out["results"] = {
        name: {"status": r.status, "drained": r.drained,
               "dropped": r.dropped,
               "error": type(r.error).__name__ if r.error else "",
               "message": str(r.error) if r.error else "",
               "segments": int(r.stats.segments) if r.stats else -1,
               "device": str(r.extras.get("device", "")),
               "migrations": int(r.extras.get("migrations", 0)),
               "plan": str(r.extras.get("plan", ""))}
        for name, r in res.items()}
    out["decisions"] = {name: _decisions(c.out) for name, c in caps.items()}
    out["counters"] = {k: float(metrics.get(k)) for k in FLEET_COUNTERS}
    out["by_label"] = {k: dict(metrics.by_label(k)) for k in FLEET_LABELED}
    out["journals"] = {
        name: _journal_summary(f["telemetry_journal_path"])
        for name, f in streams.items()
        if f.get("telemetry_journal_path")
        and os.path.exists(f["telemetry_journal_path"])}
    out["debris_left"] = [int(os.path.exists(o))
                          for _m, o in (debris or {}).values()]
    text = metrics.prometheus()
    out["prom"] = [int(p in text) for p in (prom or ())]
    metrics.reset()
    return out


def fleet_resume(pkg: str, golden: dict, first: dict, second: dict
                 ) -> dict:
    """A stream killed on pool member 0 (its first run's fatal fault)
    resumes pinned to member 1: its output set against an uninterrupted
    golden run's, and fsck of its run directory."""
    Config, F, Pipeline, metrics = _fleet_mods(pkg)
    imp = importlib.import_module
    snapshot = imp(f"{pkg}.tools.crash_soak").snapshot_outputs
    fsck = imp(f"{pkg}.tools.fsck").fsck
    kw = _cpu_kw(pkg)
    metrics.reset()
    with Pipeline(Config(**golden), **kw) as pipe:
        pipe.run()
    gold = snapshot(os.path.dirname(golden["baseband_output_file_prefix"]))
    out = {"golden_files": len(gold)}
    for tag, fields, pin in (("p1", first, 0), ("p2", second, 1)):
        metrics.reset()
        fleet = F.StreamFleet([F.StreamSpec(name="mig",
                                            cfg=Config(**fields),
                                            pin_device=pin)], **kw)
        r = fleet.run()["mig"]
        fleet.close()
        out[tag] = {"status": r.status, "device": r.extras["device"],
                    "dropped": r.dropped}
    run_dir = os.path.dirname(second["baseband_output_file_prefix"])
    out["equal"] = int(snapshot(run_dir) == gold)
    rep = fsck(second["run_manifest_path"], second["checkpoint_path"])
    out["fsck_clean"] = int(bool(rep["clean"]))
    metrics.reset()
    return out


def fleet_units(pkg: str) -> dict:
    """The fleet's pure parts, scripted: admission (capacity, queue,
    priority eviction, the loner-family tie-break), the shed policy's
    order and hysteresis (batch-aware too), placement, the pool, the
    batch former on stub lanes, the v10/v11 span fields."""
    imp = importlib.import_module
    A = imp(f"{pkg}.resilience.admission")
    D = imp(f"{pkg}.resilience.degrade")
    PL = imp(f"{pkg}.pipeline.placement")
    P = imp(f"{pkg}.pipeline.pool")
    F = imp(f"{pkg}.pipeline.fleet")
    T = imp(f"{pkg}.utils.telemetry")
    metrics = imp(f"{pkg}.utils.metrics").metrics
    out: dict = {}
    metrics.reset()
    adm = A.AdmissionController(max_streams=2, queue_limit=1)
    out["adm"] = [adm.request("a", 0), adm.request("b", 0),
                  adm.request("c", 1), adm.request("d", 0),
                  adm.request("e", 5)]
    out["adm_rejected"] = list(adm.rejected)
    out["adm_queued"] = list(adm.queued)
    adm.release("a")
    out["adm_pop"] = [str(adm.pop_ready()), str(adm.pop_ready())]
    out["adm_metrics"] = [metrics.get("fleet_rejected"), metrics.get(
        "fleet_admitted", labels={"stream": "e"})]
    adm = A.AdmissionController(max_streams=0)
    out["adm_unlimited"] = [adm.request(f"s{i}", 0) for i in range(10)]
    ac = A.AdmissionController(max_streams=1, queue_limit=2)
    out["adm_loner"] = [ac.request("run0", priority=0, plan_key="k1"),
                        ac.request("lone", priority=0, plan_key="k2"),
                        ac.request("mate", priority=0, plan_key="k1"),
                        ac.request("vip", priority=5, plan_key=None)]
    out["adm_loner_rejected"] = list(ac.rejected)
    out["adm_loner_queued"] = list(ac.queued)
    ac = A.AdmissionController(max_streams=1, queue_limit=2)
    out["adm_nokey"] = [ac.request("run0", priority=0),
                        ac.request("q0", priority=0),
                        ac.request("q1", priority=0),
                        ac.request("vip", priority=5)]
    out["adm_nokey_rejected"] = list(ac.rejected)
    ac.note_migration("run0", "dev0", "dev1")
    out["readmitted"] = [metrics.get("fleet_readmitted"), metrics.get(
        "fleet_readmitted", labels={"device": "dev1"})]
    # the shed policy
    metrics.reset()
    pol = D.FleetShedPolicy(high=0.9, low=0.25, hold=2)
    lanes = [("hi", 5, True), ("mid", 3, True), ("lo", 1, True),
             ("file", 0, False)]
    out["shed"] = [sorted(pol.observe(p, False, lanes))
                   for p in (1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                             0.5, 0.0)]
    out["shed_lo"] = metrics.get("fleet_sheds", labels={"stream": "lo"})
    pol = D.FleetShedPolicy(hold=1)
    blanes = [("bat", 0, True, True), ("solo", 0, True, False)]
    out["shed_batched"] = [sorted(pol.observe(p, False, blanes))
                           for p in (1.0, 1.0, 0.0)]
    pol = D.FleetShedPolicy(hold=1)
    out["shed_3tuple"] = sorted(pol.observe(1.0, False, [("a", 0, True),
                                                         ("b", 1, True)]))
    pol = D.FleetShedPolicy(hold=1)
    out["shed_loss"] = sorted(pol.observe(0.0, True, lanes))
    try:
        D.FleetShedPolicy(high=0.2, low=0.5)
        out["shed_bad"] = ""
    except ValueError as e:
        out["shed_bad"] = str(e)
    # placement
    metrics.reset()
    pool = P.DevicePool(3)

    class Spec:
        def __init__(self, name, pin=None):
            self.name = name
            self.pin_device = pin
    devs = pool.devices
    out["tenant"] = [PL.tenant_of("radioA.band0"), PL.tenant_of("flat"),
                     PL.tenant_of("a.b.c")]
    out["initial"] = [
        PL.choose_initial(Spec("x"), devs, {0: 1, 1: 0, 2: 0}).index,
        PL.choose_initial(Spec("x"), devs, {}).index,
        PL.choose_initial(Spec("r.b2"), devs, {0: 0, 1: 0, 2: 1},
                          {0: {"r"}, 1: set()}).index,
        PL.choose_initial(Spec("r.b3"), devs[:2], {0: 0, 1: 0},
                          {0: {"r"}, 1: {"r"}}).index,
        PL.choose_initial(Spec("p", pin=2), devs, {2: 9}).index]
    pins = []
    for pin, healthy in ((5, devs), (1, [devs[0], devs[2]])):
        try:
            PL.choose_initial(Spec("p", pin=pin), healthy, {})
            pins.append("")
        except ValueError as e:
            pins.append(str(e))
    out["pin_errors"] = pins
    out["target"] = [
        PL.choose_target("s", 0, devs, {0: 0, 1: 2, 2: 1}).index,
        str(PL.choose_target("s", 0, devs[:1], {0: 0})),
        PL.choose_target("t.x", 1, devs, {0: 1, 1: 0, 2: 1},
                         {0: {"t"}, 2: set()}).index]
    # the pool
    metrics.reset()
    one = P.DevicePool(1)
    out["pool1"] = [len(one), one.devices[0].label,
                    metrics.get("fleet_pool_size")]
    pool = P.DevicePool(2)
    out["pool_distinct"] = int(pool.devices[0].plans
                               is not pool.devices[1].plans)
    dev = pool.devices[1]
    dev.schedule_halt(2)
    fired = []
    for _ in range(5):
        try:
            dev.note_dispatch()
            fired.append(0)
        except Exception as e:  # noqa: BLE001 - the virtual halt
            fired.append(1)
            out["halt_type"] = type(e).__name__
            out["halt_msg"] = str(e)
    out["halt_fired"] = fired
    dev0 = pool.devices[0]
    dev0.schedule_halt(0)
    dev0.note_dispatch(check=False)
    out["batch_skip"] = dev0.dispatches
    try:
        dev0.note_dispatch()
        out["after_batch"] = 0
    except Exception:  # noqa: BLE001 - fires at the solo boundary
        out["after_batch"] = 1
    dev.set_state(P.STATE_HALTED)
    pool.devices[0].set_state(P.STATE_DRAINING)
    out["gauges"] = [metrics.get("fleet_device_state",
                                 labels={"device": "dev0"}),
                     metrics.get("fleet_device_state",
                                 labels={"device": "dev1"})]
    out["healthy_halted"] = [d.index for d in pool.healthy()]
    try:
        dev.set_state("bogus")
        out["bad_state"] = ""
    except ValueError as e:
        out["bad_state"] = str(e)
    pool.invalidate_all()
    out["rearmed"] = [d.state for d in pool.devices]
    out["total_dispatches"] = pool.total_dispatches
    # the batch former on stub lanes (the reference's own stubs)

    class StubLane:
        def __init__(self, name, priority, proc):
            self.name = name
            self.priority = priority
            self.pipe = type("P", (), {"processor": proc})()

    def former(batch_max, linger_s=0.0):
        f = F._BatchFormer.__new__(F._BatchFormer)
        F._BatchFormer.__init__(f, fleet=None, batch_max=batch_max,
                                linger_s=linger_s)
        return f
    proc = object()
    fm = former(4)
    shared, solo = [], []
    fm._dispatch_shared = lambda p, slots: shared.append(
        [s.lane.name for s in slots])
    fm._single_fallback = lambda slot, requeue=False: solo.append(
        slot.lane.name)
    lanes = [StubLane("low", 0, proc), StubLane("high", 9, proc),
             StubLane("mid", 1, proc)]
    for i, lane in enumerate(lanes):
        fm.offer(lane, (object(), 0, 0.0), i)
    out["former_before"] = len(shared)
    out["former_flush"] = int(fm.flush_all())
    for i, lane in enumerate(lanes + lanes[:2]):
        fm.offer(lane, (object(), 0, 0.0), 10 + i)
    out["former_auto"] = len(shared)
    fm.flush_all()
    out["former_shared"] = shared
    out["former_solo"] = solo
    fm = former(4, linger_s=0.05)
    solo2 = []
    fm._single_fallback = lambda slot, requeue=False: solo2.append(1)
    fm.offer(StubLane("a", 0, object()), (object(), 0, 0.0), 0)
    pumps = [int(fm.pump())]
    time.sleep(0.08)
    pumps += [int(fm.pump()), int(fm.pump())]
    out["former_pump"] = pumps
    out["former_pump_solo"] = len(solo2)
    pa, pb = object(), object()
    fm = former(2)
    calls = []
    fm._dispatch_shared = lambda p, slots: calls.append(
        (int(p is pa), sorted(s.lane.name for s in slots)))
    fm._single_fallback = lambda slot, requeue=False: None
    fm.offer(StubLane("a0", 0, pa), (object(), 0, 0.0), 0)
    fm.offer(StubLane("b0", 0, pb), (object(), 0, 0.0), 0)
    out["former_groups_before"] = len(calls)
    fm.offer(StubLane("a1", 0, pa), (object(), 0, 0.0), 0)
    out["former_groups"] = calls
    fm = former(4)
    x = StubLane("x", 0, proc)
    fm.offer(x, (object(), 0, 0.0), 0)
    fm.drop_lane(x)
    out["former_dropped"] = len(fm._groups)
    # the v10 / v11 span fields
    rec = T.segment_span(0, {"dispatch": 0.1}, 0, 0, False, 1024)
    out["span_solo"] = sorted(k for k in ("batch_size", "batch_wait_ms",
                                          "device") if k in rec)
    rec = T.segment_span(0, {"dispatch": 0.1}, 0, 0, False, 1024,
                         batch_size=3, batch_wait_ms=1.234, device="dev1",
                         stream="x")
    out["span_batched"] = [rec["batch_size"], rec["batch_wait_ms"],
                           rec["device"], rec["v"], rec["stream"]]
    metrics.reset()
    return out



# ------------------------------------- the archive replay (A8c)
# Scripted runners that take the package's name, as the fleet's: one
# script drives the JAX package's archive replay (in this runner's
# interpreter) and the port's (in the pytest process, on the CPU).


def _archive_mods(pkg: str):
    imp = importlib.import_module
    return (imp(f"{pkg}.config").Config, imp(f"{pkg}.pipeline.archive"),
            imp(f"{pkg}.tools.archive_replay"),
            imp(f"{pkg}.utils.metrics").metrics)


def _sha_listing(pkg: str, d: str) -> dict:
    """The archive tool's own ``_sha_map`` of ``d``, as canonical JSON."""
    return json.dumps(_archive_mods(pkg)[2]._sha_map(d), sort_keys=True)


def archive_report(rep) -> str:
    """An ``ArchiveReport``'s ``as_dict()`` less its clock fields, as
    canonical JSON (the counts, statuses and per-file dicts)."""
    d = rep.as_dict()
    for k in ("elapsed_s", "segments_per_sec"):
        d.pop(k)
    return json.dumps(d, sort_keys=True)


def archive_passes(pkg: str, base_fields: dict, files: list, out_dir: str,
                   passes: list) -> dict:
    """``ArchiveReplay(Config(**base_fields), files, out_dir, **kw).run()``
    once for each ``kw`` of ``passes``, in order, from a fresh registry:
    each pass's report and the artifact map after it."""
    Config, A, _AR, metrics = _archive_mods(pkg)
    metrics.reset()
    out = {}
    for i, kw in enumerate(passes):
        rep = A.ArchiveReplay(Config(**base_fields), files, out_dir,
                              **kw, **_cpu_kw(pkg)).run()
        out[f"{i}/report"] = archive_report(rep)
        out[f"{i}/sha"] = _sha_listing(pkg, out_dir)
    metrics.reset()
    return out


def archive_goldens(pkg: str, n: int, files: list, gdir: str,
                    **extra) -> dict:
    """Each file's streamed golden (the solo engine, deterministic
    timestamps, window 2, outputs ``bb<i>_`` under ``gdir``): the artifact
    map and the runs' segments and signals."""
    Config, _A, AR, metrics = _archive_mods(pkg)
    Pipeline = importlib.import_module(f"{pkg}.pipeline.runtime").Pipeline
    os.makedirs(gdir, exist_ok=True)
    segs, sigs = [], []
    for i, f in enumerate(files):
        metrics.reset()
        cfg = Config(**AR._science_cfg(n)).replace(
            input_file_path=f,
            baseband_output_file_prefix=os.path.join(gdir, f"bb{i}_"),
            deterministic_timestamps=True, inflight_segments=2, **extra)
        with Pipeline(cfg, **_cpu_kw(pkg)) as pipe:
            stats = pipe.run()
        segs.append(stats.segments)
        sigs.append(stats.signals)
    metrics.reset()
    return {"sha": _sha_listing(pkg, gdir), "segments": segs,
            "signals": sigs}


def archive_stamps(pkg: str, n: int, path: str) -> dict:
    """The deterministic reader's stamps of ``path``, read twice, its class
    name, and whether the default reader is the deterministic one."""
    Config, _A, AR, _m = _archive_mods(pkg)
    FI = importlib.import_module(f"{pkg}.io.file_input")
    cfg = Config(**AR._science_cfg(n)).replace(
        input_file_path=path, deterministic_timestamps=True)
    stamps = []
    for _ in range(2):
        r = FI.make_file_source(cfg)
        stamps.append([int(w.timestamp) for w in r])
        r.close()
    off = FI.make_file_source(cfg.replace(deterministic_timestamps=False))
    off_det = isinstance(off, FI.DeterministicTimestampReader)
    off.close()
    return {"stamps": np.array(stamps, dtype=np.int64),
            "epoch": int(FI.DETERMINISTIC_EPOCH_NS),
            "cls": type(FI.make_file_source(cfg)).__name__,
            "off_is_deterministic": off_det}


def archive_pipeline_twice(pkg: str, n: int, path: str, tmp: str) -> dict:
    """Two pipeline runs of one file with deterministic timestamps, each
    into its own directory: their artifact maps."""
    Config, _A, AR, metrics = _archive_mods(pkg)
    Pipeline = importlib.import_module(f"{pkg}.pipeline.runtime").Pipeline
    out = {}
    for tag in ("a", "b"):
        d = os.path.join(tmp, tag)
        os.makedirs(d)
        metrics.reset()
        cfg = Config(**AR._science_cfg(n)).replace(
            input_file_path=path,
            baseband_output_file_prefix=os.path.join(d, "out_"),
            deterministic_timestamps=True)
        with Pipeline(cfg, **_cpu_kw(pkg)) as pipe:
            pipe.run()
        out[tag] = _sha_listing(pkg, d)
    metrics.reset()
    return out


def archive_guards(pkg: str, n: int, tmp: str) -> dict:
    """The engine's input validation (the exception's type and message of
    each refusal) and ``stream_name_for`` on the reference's cases."""
    Config, A, AR, _m = _archive_mods(pkg)
    base = Config(**AR._science_cfg(n))
    errors = []
    for files in ([], [os.path.join(tmp, "nope.bin")]):
        try:
            A.ArchiveReplay(base, files, tmp)
            errors.append("")
        except (ValueError, FileNotFoundError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    taken: set = set()
    names = [A.stream_name_for(p, taken) for p in (
        "/a/obs.bin", "/b/obs.bin", "/c/weird name!.raw", "/d/obs.bin",
        "/e/.bin", "/f/obs.1.bin")]
    return {"errors": np.array(errors), "names": np.array(names),
            "defaults": [A.DEFAULT_LANES, A.DEFAULT_MICRO_BATCH,
                         A.DEFAULT_INFLIGHT]}


def archive_cli(pkg: str, n: int, path: str, out_dir: str) -> dict:
    """``archive_replay.main`` on one file (the reference's CLI test): its
    return code and its last line, the report, less its clock fields."""
    import contextlib
    import io
    _C, _A, AR, metrics = _archive_mods(pkg)
    argv = ["--files", path, "--out-dir", out_dir, "--micro-batch", "1",
            "--inflight", "2", "--lanes", "1"]
    for k, v in sorted(AR._science_cfg(n).items()):
        argv += ["--set", f"{k}={int(v) if isinstance(v, bool) else v}"]
    if pkg == "srtb_tpu_torch":
        argv += ["--device", "cpu"]
    metrics.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = AR.main(argv)
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = sorted(rep)
    for k in ("elapsed_s", "segments_per_sec"):
        rep.pop(k)
    metrics.reset()
    return {"rc": rc, "keys": np.array(keys),
            "report": json.dumps(rep, sort_keys=True)}


# --------------------------------- status, console and tsan (A8c)


def status_console_script(pkg: str, store_dir: str) -> dict:
    """``fleet_status`` and ``console.render`` on the metric state and the
    rollup store of ``tests/test_obs.py``'s status test, plus a stream's
    gauges and a digest row: the status as canonical JSON and the frame."""
    imp = importlib.import_module
    ST = imp(f"{pkg}.obs.status")
    CON = imp(f"{pkg}.tools.console")
    S = imp(f"{pkg}.obs.store")
    D = imp(f"{pkg}.obs.digest")
    metrics = imp(f"{pkg}.utils.metrics").metrics
    metrics.reset()
    metrics.set("fleet_device_state", 0, labels={"device": "dev0"})
    metrics.set("fleet_device_state", 2, labels={"device": "dev1"})
    metrics.set("fleet_device_state", 7, labels={"device": "dev2"})
    metrics.set("fleet_device_lanes", 3, labels={"device": "dev0"})
    metrics.add("migrations", 2)
    metrics.add("migrations", labels={"device": "dev0"}, value=2)
    metrics.add("device_drains", labels={"device": "dev1"})
    metrics.set("roofline_frac", 0.062)
    metrics.add("batched_dispatches", 4)
    metrics.add("batched_segments", 10)
    metrics.add("segments", 5, labels={"stream": "s0"})
    metrics.set("roofline_frac", 0.12345678, labels={"stream": "s0"})
    metrics.set("achieved_msamps", 812.5, labels={"stream": "s0"})
    store = S.RollupStore(store_dir)
    store.append({"k": "e:1", "type": "fleet_event", "minute": 1,
                  "ts": 61.0, "kind": "fleet.migrate", "stream": "s0",
                  "seg": 3, "info": "dev0->dev1"})
    store.append({"k": "m:1:s0", "type": "rollup_minute", "minute": 1,
                  "segments": 5})
    dig = D.QuantileDigest()
    for v in (1.0, 2.0, 3.0, 40.0):
        dig.add(v)
    store.append({"k": "d:stage:dispatch", "type": "rollup_digest",
                  "kind": "stage", "label": "dispatch",
                  "digest": dig.to_dict()})
    status = ST.fleet_status(store_dir=store_dir)
    bare = ST.fleet_status()
    empty = ST.fleet_status(store_dir=os.path.join(store_dir, "none"))
    out = {"status": json.dumps(status, sort_keys=True),
           "bare": json.dumps(bare, sort_keys=True),
           "empty_store": json.dumps(empty.get("store"), sort_keys=True),
           "frame": CON.render(status),
           "thin_frame": CON.render({}),
           "bars": np.array([CON._bar(f) for f in (-1.0, 0.0, 0.26, 1.0,
                                                   3.0)]),
           "recent": [ST.RECENT_MINUTES, ST.RECENT_EVENTS]}
    metrics.reset()
    return out



def console_url_script(pkg: str, directory: str) -> dict:
    """The package's viewer on an OS-chosen port with one pool member
    ``dev0`` ok, then ``console.main(["--url", base, "--once"])`` and the
    same with ``--json``: their return codes and outputs, ``/fleet``'s
    status, type and body, and the console's rc against a closed port."""
    import contextlib
    import io
    import urllib.request
    imp = importlib.import_module
    server_cls = imp(f"{pkg}.gui.server").WaterfallHTTPServer
    CON = imp(f"{pkg}.tools.console")
    metrics = imp(f"{pkg}.utils.metrics").metrics
    metrics.reset()
    metrics.set("fleet_device_state", 0, labels={"device": "dev0"})
    srv = server_cls(directory, port=0).start()
    out: dict = {}
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for key, extra in (("text", []), ("json", ["--json"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[f"{key}_rc"] = CON.main(["--url", base, "--once",
                                             *extra])
            out[key] = buf.getvalue()
        with urllib.request.urlopen(base + "/fleet",
                                    timeout=VIEWER_TIMEOUT_S) as r:
            out["fleet_status"] = r.status
            out["fleet_type"] = r.headers.get("Content-Type", "")
            out["fleet_body"] = r.read().decode()
    finally:
        srv.stop()
    with contextlib.redirect_stderr(io.StringIO()):
        out["closed_rc"] = CON.main(["--url", base, "--once"])
    metrics.reset()
    return out

def tsan_script(pkg: str) -> dict:
    """The runtime concurrency checker, scripted on one thread (plus one
    intruder thread of a fixed name): the perturbers' journals and
    decisions for fixed seeds, rates and site sequences, each trap's
    message, the order graph's report and the race soak's selftest."""
    T = importlib.import_module(f"{pkg}.analysis.tsan")
    RS = importlib.import_module(f"{pkg}.tools.race_soak")
    out: dict = {}
    seq = (["fleet._wake"] * 40 + ["lane.s0._live_lock"] * 40
           + ["fleet._wake", "lane.s1._live_lock"] * 20
           + ["former.groups", "lane.stream0._live_lock"] * 7)
    for seed, rate in ((0, 0.25), (42, 0.3), (7, 0.5), (123, 0.05),
                       (9, 1.0)):
        p = T.SchedulePerturber(seed, rate=rate, sleep_s=0.0)
        for site in seq:
            p.perturb(site)
        out[f"journal/{seed}"] = json.dumps(p.journal)
        out[f"decide/{seed}"] = np.array(
            [p.decide(s, k) for s in ("x", "fleet._wake") for k in
             range(128)])
    msgs = []

    def trap(fn):
        try:
            fn()
            msgs.append("")
        except T.TsanError as e:
            msgs.append(str(e))
    ts = T.Tsan()
    a, b, c = ts.lock("A"), ts.lock("B"), ts.lock("C")

    def nest(*locks):
        def run():
            held = []
            try:
                for lk in locks:
                    lk.acquire()
                    held.append(lk)
            finally:
                for lk in reversed(held):
                    lk.release()
        return run
    trap(nest(a, b))
    trap(nest(b, c))
    trap(nest(c, a))
    trap(nest(b, a))
    trap(nest(a, a))
    cv = ts.condition("cv")
    trap(cv.notify_all)
    trap(lambda: cv.wait(0.01))
    trap(lambda: cv.notify(1))
    ts.assert_owner("lane.s0.step")

    def intruder():
        trap(lambda: ts.assert_owner("lane.s0.step"))
    t = threading.Thread(target=intruder, name="intruder")
    t.start()
    t.join()
    rep = ts.report()
    out["messages"] = np.array(
        [m.replace(threading.current_thread().name, "<main>")
         for m in msgs])
    out["report"] = json.dumps({k: rep[k] for k in ("order_edges",
                                                    "order_nodes")})
    out["owners"] = sorted(rep["owners"])
    out["selftest"] = np.array(RS.selftest() or [""])
    return out


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
    if sys.argv[1] == "--world-rank":
        _world_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        _main(sys.argv[1], sys.argv[2])

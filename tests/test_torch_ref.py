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
    return res


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

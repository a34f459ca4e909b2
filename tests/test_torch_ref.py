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
        "plan": sp.plan_name, "window": sp.window,
        "dewindow": sp.watfft_dewindow, "rfi_mask": sp.rfi_mask,
        "norm_coeff": sp.norm_coeff, "nsamps_reserved": sp.nsamps_reserved,
        "time_reserved_count": sp.time_reserved_count, **out,
    }


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

"""The distributed layer of the port (``parallel/mesh.py``,
``distributed.py``, ``dist_fft.py``, ``segment_dist.py`` beyond one
device) against the JAX package's, on CPU gloo process groups: the
counterparts of the reference's ``tests/test_distributed.py``,
``test_dist_fft.py`` and ``test_parallel.py``.

Each world (``test_torch_ref.run_world``) is spawned once for the module
and runs every case, each rank a process on one thread, meeting at a
``file://`` rendezvous under the test's directory; the reference runs in
``test_torch_ref.py``'s subprocess on its eight virtual CPU devices, its
own meshes.  Inputs are made from numpy seeds in every rank and in both
packages.  Gates, the reference's own: ``dist_fft`` rtol 1e-3, atol
3e-2 sqrt(n) (``test_dist_fft.py``); the large-n twiddle precision a
relative RMS error under 5e-6 against float64; the B6 legs and the
in-shard four-step within 2e-5 of the largest value; the sharded step's
counts and zero counts exact, its series rtol 2e-3, atol 1e-2
(``test_parallel.py:116-121``) and its peaks rtol 2e-4, atol 1e-3 (the DM
search's gate); the collective inventory equal to the reference's
``Counter`` (``test_parallel.py:320-325``).  The whole module takes
about a minute on one worker."""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.parallel import dist_fft as DF
from srtb_tpu_torch.parallel import distributed as D
from srtb_tpu_torch.parallel import mesh as M
from srtb_tpu_torch.parallel.segment_dist import DistSegmentProcessor
from test_torch_dm_search import (PEAK_TOL, RAW, RAW2, SERIES_TOL,
                                  parallel_cfg)
from test_torch_pipeline import make_case
from test_torch_ref import REPO, environ, run_reference, run_world

WORLD = 8
# the reference interpreters the module's jobs are shared among
REF_SPLIT = 3
# the FFT cases: key -> (kind, log2n, inverse, rows_impl, len_cap)
FFT = {f"c2c_{n}_{'inv' if inv else 'fwd'}": ("c2c", n, inv, "xla", None)
       for n in (10, 14, 16) for inv in (False, True)}
FFT.update({f"r2c_{n}": ("r2c", n, False, "xla", None) for n in (12, 16)})
# the reference's slow cases, here in the same world: n = 2^24 (legs of
# [2048, 4096] a rank, inside B6's window), and the in-shard recursion
LARGE = {"c2c_24": ("c2c", 24, False, "xla", None),
         "r2c_24": ("r2c", 24, False, "xla", None),
         "c2c_24_pallas": ("c2c", 24, False, "pallas", None),
         "r2c_24_pallas": ("r2c", 24, False, "pallas", None),
         "c2c_18_recursion": ("c2c", 18, False, "pallas", 1 << 8)}
# the sharded step's cases: key -> (cfg overrides, raw, trials, n_dm,
# n_seq, window, environment)
STEP = {"dm2_seq4": ({}, RAW, [30.0, 0.0], 2, 4, "rectangle", None),
        "dm1_seq4": ({}, RAW, [30.0, 0.0], 1, 4, "rectangle", None),
        "seq8": ({}, RAW, [30.0], 1, 8, "rectangle", None),
        "hamming": ({}, RAW, [30.0, 0.0], 2, 4, "hamming", None),
        "two_streams": ({"baseband_format_type": "interleaved_samples_2"},
                        RAW2, [0.0, 10.0], 2, 4, "rectangle", None),
        "grid": ({}, RAW, [0.0, 15.0, 30.0, 45.0], 2, 4, "rectangle",
                 None),
        "pallas_legs": ({}, RAW, [30.0, 0.0], 2, 4, "rectangle",
                        {"SRTB_DIST_ROWS_IMPL": "pallas"})}
BAD_CHANNELS = dataclasses.asdict(Config(
    baseband_input_count=1 << 14, baseband_input_bits=2,
    baseband_format_type="simple", baseband_freq_low=1405.0,
    baseband_bandwidth=64.0, baseband_sample_rate=128e6, dm=5.0,
    spectrum_channel_count=48, signal_detect_max_boxcar_length=8,
    baseband_reserve_sample=False))
# the errors both packages raise: (kind, *args)
ERRORS = [("step", BAD_CHANNELS, 2, 2, [1.0, 2.0, 3.0, 4.0]),
          ("step", dataclasses.asdict(parallel_cfg()), 2, 4, [1.0, 2.0, 3.0]),
          ("mesh", 3, 1),
          ("local", 2, 3),
          ("init", dataclasses.asdict(parallel_cfg(
              distributed_num_processes=2)))]


def fft_input(kind: str, log2n: int) -> np.ndarray:
    """The reference's tests' inputs: seeded by log2n (42 for the real
    2^24 case, as its precision test)."""
    n = 1 << log2n
    if kind == "c2c":
        rng = np.random.default_rng(log2n)
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                ).astype(np.complex64)
    rng = np.random.default_rng(42 if log2n == 24 else log2n)
    return rng.standard_normal(n).astype(np.float32)


def _inventory(mesh: M.Mesh) -> np.ndarray:
    return np.array(sorted(f"{name} {','.join(ax)} {c}" for (name, ax), c
                           in mesh.inventory.items()))


@contextlib.contextmanager
def legs_seen():
    """The leg implementations the distributed FFT hands ``fft_minor``
    inside the block, as a list."""
    seen, minor = [], DF.fft_minor

    def spy(x, inverse, rows_impl="xla", len_cap=None):
        seen.append(rows_impl)
        return minor(x, inverse, rows_impl, len_cap)
    DF.fft_minor = spy
    try:
        yield seen
    finally:
        DF.fft_minor = minor


# ------------------------------------------------ the ranks' cases

def case_fft(kind: str, log2n: int, inverse: bool, rows_impl: str,
             len_cap) -> dict:
    """This rank's block of ``dist_fft`` / ``dist_rfft_drop_nyquist`` on a
    seq mesh of the whole world, and the leg implementations used."""
    mesh = M.seq_mesh(WORLD)
    x = fft_input(kind, log2n)
    blk = x.size // WORLD
    r = mesh.index("seq")
    local = torch.from_numpy(x[r * blk:(r + 1) * blk].copy())
    with legs_seen() as seen:
        if kind == "c2c":
            y = DF.dist_fft(local, mesh, inverse=inverse,
                            rows_impl=rows_impl, len_cap=len_cap)
        else:
            y = DF.dist_rfft_drop_nyquist(local, mesh, rows_impl=rows_impl,
                                          len_cap=len_cap)
    return {"y": y.numpy(), "impls": np.array(sorted(set(seen))),
            "inventory": _inventory(mesh)}


def case_step(fields: dict, raw: np.ndarray, dm_list: list, n_dm: int,
              n_seq: int, window: str, env) -> dict:
    """The sharded step on the first n_dm x n_seq ranks (a rank outside
    the mesh takes no part): the replicated summaries, this rank's trials'
    series, its coordinates, the mesh's collective inventory and the leg
    implementations used."""
    with environ(env), legs_seen() as seen:
        mesh = M.make_mesh(n_dm, n_seq)
        if mesh.coords is None:  # it made every group with the others
            return {"in_mesh": np.array(0)}
        proc = DistSegmentProcessor(Config(**fields), mesh, dm_list,
                                    window_name=window, device="cpu")
        res = proc.process(raw)
    return {"in_mesh": np.array(1), "result": res._asdict(),
            "coords": np.array([mesh.index("dm"), mesh.index("seq")]),
            "inventory": _inventory(mesh), "impls": np.array(sorted(set(seen))),
            "sharded": np.array(proc.sharded)}


def case_errors(cases: list) -> dict:
    """The message each of ERRORS raises in the port."""
    out = []
    for kind, *args in cases:
        try:
            if kind == "step":
                fields, n_dm, n_seq, dm_list = args
                DistSegmentProcessor(Config(**fields),
                                     M.make_mesh(n_dm, n_seq), dm_list,
                                     device="cpu")
            elif kind == "mesh":
                M.make_mesh(*args)
            elif kind == "local":
                D.process_local_dm_indices(M.make_mesh(args[0], 1),
                                           args[1])
            else:
                D.maybe_initialize_from_config(Config(**args[0]),
                                               device="cpu")
            out.append("")
        except Exception as e:  # the case's refusal, reported
            out.append(f"{type(e).__name__}: {e}")
    return {"messages": np.array(out)}


def case_hybrid() -> dict:
    """The hybrid meshes of the whole world: one host at n_seq 2, two
    hosts of four (``local_world_size``) at n_seq 2, the bad n_seq."""
    one = D.hybrid_dm_seq_mesh(n_seq=2)
    two = D.hybrid_dm_seq_mesh(n_seq=2, local_world_size=WORLD // 2)
    try:
        D.hybrid_dm_seq_mesh(n_seq=3)
        bad = ""
    except ValueError as e:
        bad = f"ValueError: {e}"
    return {"one": one.devices, "names": np.array(one.axis_names),
            "two": two.devices, "bad": np.array(bad),
            "slices": np.array(D.rank_slices(WORLD // 2))}


def case_two_hosts() -> dict:
    """The reference's two-process worker on "two hosts x two ranks"
    (torchrun's ``GROUP_RANK`` faked a rank): the hybrid mesh keeps each
    seq row on one host; a sum over the whole mesh; the trial ownership;
    the sharded step with trials across the hosts and the sequence within
    each; the seq-parallel FFT across the hosts."""
    mesh = D.hybrid_dm_seq_mesh(n_seq=2)
    slices = D.rank_slices()
    n_dm, n_seq = mesh.devices.shape
    shape = (n_dm * 2, n_seq * 3)
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    dm, seq = mesh.index("dm"), mesh.index("seq")
    part = torch.from_numpy(full[dm * 2:(dm + 1) * 2, seq * 3:(seq + 1) * 3]
                            .sum(keepdims=True).reshape(1))
    total = mesh.psum(mesh.psum(part, "seq"), "dm")
    cfg = parallel_cfg(signal_detect_signal_noise_threshold=6.0)
    raw = np.random.default_rng(3).integers(0, 256, size=cfg.segment_bytes(1),
                                            dtype=np.uint8)
    res = DistSegmentProcessor(cfg, mesh, dm_list=[0.0, 15.0, 30.0, 60.0],
                               device="cpu").process(raw)
    peaks, counts = res.snr_peaks.numpy(), res.signal_counts.numpy()
    digest = hashlib.sha256(peaks.tobytes() + counts.tobytes()).hexdigest()
    x = fft_input("c2c", 10)
    smesh = M.seq_mesh(4)
    r = smesh.index("seq")
    y = DF.dist_fft(torch.from_numpy(x[r * 256:(r + 1) * 256].copy()), smesh)
    return {"mesh": mesh.devices, "slices": np.array(slices),
            "total": total.numpy(), "expected": np.array(full.sum()),
            "local": np.array(D.process_local_dm_indices(mesh, 4)),
            "peaks": peaks, "digest": np.array(digest), "fft": y.numpy(),
            "fft_index": np.array(r)}


def case_dm_search(fields: dict, env: dict) -> dict:
    """``DMSearchPipeline`` over the whole world's mesh under ``env``:
    its records (rank 0's file), the step's kind and legs, and the
    collectives of the run."""
    from srtb_tpu_torch.pipeline.runtime import DMSearchPipeline
    with environ(env):
        search = DMSearchPipeline(Config(**fields), device="cpu")
    with search:
        stats = search.run()
    proc = search.processor
    lines = []
    if M.rank() == 0:
        with open(search.trials_path) as f:
            lines = [ln for ln in f.read().splitlines() if ln]
    return {"records": np.array(lines), "segments": np.array(stats.segments),
            "sharded": np.array(proc.sharded),
            "legs": np.array(proc.rows_impl),
            "inventory": _inventory(proc.mesh)}


# --------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the 8-rank world's and the two-host
    world's, made at once."""
    ref_jobs = [{"key": k, "fn": "test_torch_ref:ref_dist_fft",
                 "args": [fft_input(kind, n)],
                 "kwargs": {"inverse": inv, "rows_impl": impl,
                            "len_cap": cap}}
                for k, (kind, n, inv, impl, cap) in FFT.items()
                if kind == "c2c"]
    ref_jobs += [{"key": k, "fn": "test_torch_ref:ref_dist_rfft",
                  "args": [fft_input(kind, n)]}
                 for k, (kind, n, _i, _r, _c) in FFT.items() if kind == "r2c"]
    ref_jobs.append({"key": "c2c_18_recursion",
                     "fn": "test_torch_ref:ref_dist_fft",
                     "args": [fft_input("c2c", 18)],
                     "kwargs": {"len_cap": 1 << 8}})
    for k, (over, raw, dms, n_dm, n_seq, window, env) in STEP.items():
        ref_jobs.append({"key": f"step/{k}", "fn": "test_torch_ref:ref_dist_step",
                         "args": [dataclasses.asdict(parallel_cfg(**over)),
                                  raw, dms, n_dm, n_seq, window, env],
                         "kwargs": {"inventory": k == "dm2_seq4"}})
    ref_jobs += [{"key": "hybrid", "fn": "test_torch_ref:ref_hybrid_layouts"},
                 {"key": "errors", "fn": "test_torch_ref:ref_errors",
                  "args": [ERRORS]}]
    world_jobs = [{"key": f"fft/{k}", "fn": "test_torch_parallel:case_fft",
                   "args": list(v)} for k, v in {**FFT, **LARGE}.items()]
    world_jobs += [{"key": f"step/{k}", "fn": "test_torch_parallel:case_step",
                    "args": [dataclasses.asdict(parallel_cfg(**over)), raw,
                             dms, n_dm, n_seq, window, env]}
                   for k, (over, raw, dms, n_dm, n_seq, window, env)
                   in STEP.items()]
    world_jobs += [{"key": "errors", "fn": "test_torch_parallel:case_errors",
                    "args": [ERRORS]},
                   {"key": "hybrid", "fn": "test_torch_parallel:case_hybrid"}]
    hosts_jobs = [{"key": "hosts", "fn": "test_torch_parallel:case_two_hosts"}]

    def host_env(r: int) -> dict:
        return {"GROUP_RANK": str(r // 2), "LOCAL_RANK": str(r % 2),
                "LOCAL_WORLD_SIZE": "2"}
    # the reference's compilations take most of the time: three
    # interpreters share its jobs
    one = tmp_path_factory.mktemp("world1")
    search_cfg = dataclasses.asdict(_dm_search_case(one))
    one_jobs = [{"key": "search", "fn": "test_torch_parallel:case_dm_search",
                 "args": [search_cfg, {"SRTB_DIST_ROWS_IMPL": "pallas"}]}]
    with ThreadPoolExecutor(REF_SPLIT + 3) as pool:
        single = pool.submit(run_world, one_jobs, one / "world", 1)
        refs = [pool.submit(run_reference, ref_jobs[i::REF_SPLIT],
                            tmp_path_factory.mktemp("parallel_ref"))
                for i in range(REF_SPLIT)]
        world = pool.submit(run_world, world_jobs,
                            tmp_path_factory.mktemp("world8"), WORLD)
        hosts = pool.submit(run_world, hosts_jobs,
                            tmp_path_factory.mktemp("hosts"), 4, host_env)
        ref = {}
        for part in refs:
            ref.update(part.result())
        return {"ref": ref, "world": world.result(),
                "hosts": hosts.result(), "single": single.result(),
                "search_cfg": search_cfg}


def _dm_search_case(d) -> Config:
    """The pipeline tests' 2^16 2-bit file of three overlapping segments
    (the pulse at DM -0.1, the reserve on) with trials around its DM."""
    argv, _nres = make_case(d)
    return Config.from_args(argv + [
        "--dm_list", " -0.3, -0.2, -0.1, 0",
        "--baseband_output_file_prefix", f"{d}/dm_"])


def _gathered(world: list, key: str) -> np.ndarray:
    return np.concatenate([w[key] for w in world])


# ------------------------------------------------------------ the FFT

@pytest.mark.parametrize("key", sorted(FFT))
def test_dist_fft_matches_reference(runs, key):
    """``dist_fft`` / ``dist_rfft_drop_nyquist`` over an 8-rank seq mesh:
    the ranks' blocks in order against the reference's 8-device result
    and numpy, at the reference's gate; 3 all-to-all (and 2 exchanges for
    the R2C) over seq."""
    kind, log2n, inverse, _impl, _cap = FFT[key]
    got = _gathered(runs["world"], f"fft/{key}/y")
    want = runs["ref"][f"{key}/y"]
    n = 1 << log2n
    x = fft_input(kind, log2n)
    if kind == "c2c":
        exact = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    else:
        exact = np.fft.rfft(x)[:-1]
    assert got.shape == want.shape == exact.shape
    tol = dict(rtol=1e-3, atol=3e-2 * np.sqrt(n))
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, exact.astype(np.complex64), **tol)
    inv = set(runs["world"][0][f"fft/{key}/inventory"].tolist())
    want_inv = {"all_to_all seq 3"} | (
        {"ppermute seq 2"} if kind == "r2c" else set())
    assert inv == want_inv


@pytest.mark.parametrize("key", ["c2c_24", "r2c_24"])
def test_dist_fft_large_n_twiddle_precision(runs, key):
    """At n = 2^24 the twiddle phase must stay exact: relative RMS error
    under 5e-6 against a float64 oracle (the reference's
    ``test_dist_fft_large_n_twiddle_precision`` and its R2C twin)."""
    kind = LARGE[key][0]
    got = _gathered(runs["world"], f"fft/{key}/y")
    n = 1 << 24
    if kind == "c2c":
        rng = np.random.default_rng(24)
        x64 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        exact = np.fft.fft(x64)
    else:
        exact = np.fft.rfft(np.random.default_rng(42).standard_normal(n))[:-1]
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 5e-6, f"rel RMS {rel:.2e}"


@pytest.mark.parametrize("key", ["c2c_24_pallas", "r2c_24_pallas",
                                 "c2c_18_recursion"])
def test_dist_fft_pallas_legs_and_recursion(runs, key):
    """The ``pallas`` legs (B6's plain version on the CPU, the reference's
    interpret mode) under the transposes at 2^24, and the in-shard
    four-step recursion forced by a length cap of 2^8 at 2^18: within
    2e-5 of the largest value of the float64 FFT and of the ``xla`` legs
    (the R2C leg-independent, the reference's gate); the recursion also
    against the reference's capped result."""
    kind, log2n = LARGE[key][:2]
    world = runs["world"]
    got = _gathered(world, f"fft/{key}/y")
    assert world[0][f"fft/{key}/impls"].tolist() == ["pallas_interpret"]
    x = fft_input(kind, log2n)
    exact = (np.fft.fft(x.astype(np.complex128)) if kind == "c2c"
             else np.fft.rfft(x.astype(np.float64))[:-1])
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() / scale < 2e-5
    if key == "c2c_18_recursion":
        want = runs["ref"]["c2c_18_recursion/y"]
        assert np.abs(got - want).max() / scale < 2e-5
    else:
        base = _gathered(world, f"fft/{key[:-len('_pallas')]}/y")
        assert np.abs(got - base).max() / scale < 2e-5


# ----------------------------------------------------- the sharded step

def _step(world: list, key: str) -> list:
    return [w for w in world if int(w[f"step/{key}/in_mesh"])]


@pytest.mark.parametrize("key", sorted(STEP))
def test_sharded_step_matches_reference(runs, key):
    """The sharded step at each mesh against the reference's on the same
    mesh: the replicated summaries equal on every rank of the mesh, the
    counts and zero counts exact, the peaks and each dm rank's series at
    the gates; the ranks outside the mesh took no part."""
    over, raw, dms, n_dm, n_seq, _w, _env = STEP[key]
    ranks = _step(runs["world"], key)
    assert len(ranks) == n_dm * n_seq
    assert all(bool(r[f"step/{key}/sharded"]) for r in ranks)
    want = runs["ref"]
    p = f"step/{key}/result"
    for r in ranks:
        for f in ("zero_count", "signal_counts", "snr_peaks"):
            np.testing.assert_array_equal(r[f"{p}/{f}"],
                                          ranks[0][f"{p}/{f}"])
    got = ranks[0]
    np.testing.assert_array_equal(got[f"{p}/signal_counts"],
                                  want[f"{p}/signal_counts"])
    np.testing.assert_array_equal(got[f"{p}/zero_count"],
                                  want[f"{p}/zero_count"])
    np.testing.assert_allclose(got[f"{p}/snr_peaks"], want[f"{p}/snr_peaks"],
                               **PEAK_TOL)
    per = len(dms) // n_dm
    for r in ranks:
        dm = int(r[f"step/{key}/coords"][0])
        np.testing.assert_allclose(
            r[f"{p}/time_series"],
            want[f"{p}/time_series"][dm * per:(dm + 1) * per], **SERIES_TOL)
    if key == "pallas_legs":
        assert got[f"step/{key}/impls"].tolist() == ["pallas_interpret"]
        base = ranks[0]
        np.testing.assert_array_equal(
            base[f"{p}/signal_counts"],
            _step(runs["world"], "dm2_seq4")[0][
                "step/dm2_seq4/result/signal_counts"])
    else:
        assert got[f"step/{key}/impls"].tolist() == ["xla"]


@pytest.mark.parametrize("key", ["dm2_seq4", "dm1_seq4", "hamming",
                                 "two_streams"])
def test_sharded_step_matches_one_card(runs, key):
    """The sharded step against the port's one-card step on the same
    segment and trials (the reference's dist-vs-single test): counts and
    zero counts exact, the series at the gate; unwindowed, the matched
    trial beats the DM-0 one.""" 
    over, raw, dms, n_dm, _seq, window, _env = STEP[key]
    one = DistSegmentProcessor(parallel_cfg(**over), dm_list=dms,
                               window_name=window, device="cpu")
    assert not one.sharded
    want = one.process(raw)
    ranks = _step(runs["world"], key)
    p = f"step/{key}/result"
    got = ranks[0]
    np.testing.assert_array_equal(got[f"{p}/signal_counts"],
                                  want.signal_counts.numpy())
    np.testing.assert_array_equal(got[f"{p}/zero_count"],
                                  want.zero_count.numpy())
    per = len(dms) // n_dm
    for r in ranks:
        dm = int(r[f"step/{key}/coords"][0])
        np.testing.assert_allclose(
            r[f"{p}/time_series"],
            want.time_series.numpy()[dm * per:(dm + 1) * per], **SERIES_TOL)
    if key in ("dm2_seq4", "dm1_seq4"):
        peaks = got[f"{p}/snr_peaks"]
        assert peaks[0].max() > peaks[1].max()
        assert got[f"{p}/signal_counts"][0].sum() > 0


def test_collective_inventory_is_the_references(runs):
    """The step's collectives at (dm 2, seq 4), counted by the mesh on
    every rank: the reference's jaxpr ``Counter`` (3 all-to-all and 2
    point-to-point over seq, 3 sums over seq, 3 over dm), whatever the
    trial count (the local trials' reductions are batched)."""
    want = runs["ref"]["step/dm2_seq4/inventory"].tolist()
    assert want == ["all_to_all seq 3", "ppermute seq 2", "psum dm 3",
                    "psum seq 3"]
    for key in ("dm2_seq4", "grid"):
        for r in _step(runs["world"], key):
            assert r[f"step/{key}/inventory"].tolist() == want


def test_errors_are_the_references(runs):
    """The non-dividing channel count, the trials that do not divide the
    dm axis, the mesh that does not divide the devices, the trial
    ownership that does not divide, and a process group asked for with
    no coordinator raise the reference's errors word for word."""
    got = runs["world"][0]["errors/messages"].tolist()
    want = runs["ref"]["errors/messages"].tolist()
    assert got == want
    assert "must divide" in got[0] and all(got)
    # every rank raised the same
    for w in runs["world"]:
        assert w["errors/messages"].tolist() == got


def test_hybrid_mesh_layouts(runs):
    """The hybrid mesh on 8 ranks as the reference's on 8 devices: one
    host at n_seq 2 is a 4 x 2 ("dm", "seq") mesh of contiguous rows; two
    hosts (four ranks each) keep every seq row on one host and lay dm
    across both; n_seq 3 raises the reference's error."""
    w, ref = runs["world"][0], runs["ref"]
    np.testing.assert_array_equal(w["hybrid/one"], ref["hybrid/one"])
    assert w["hybrid/names"].tolist() == ref["hybrid/names"].tolist() == \
        ["dm", "seq"]
    np.testing.assert_array_equal(w["hybrid/two"], ref["hybrid/two_ids"])
    slices = w["hybrid/slices"]
    for row in w["hybrid/two"]:
        assert len({int(slices[r]) for r in row}) == 1
    assert {int(slices[row[0]]) for row in w["hybrid/two"]} == {0, 1}
    assert str(w["hybrid/bad"]) == str(ref["hybrid/bad"]) != ""


def test_hybrid_layout_without_a_group():
    """The layout is a function of the ranks' slices alone: uneven slices
    and a bad n_seq raise the reference's errors; without a process group
    the mesh is the degenerate (1, 1) one, and a larger mesh raises."""
    np.testing.assert_array_equal(D.hybrid_layout([0, 0, 1, 1], 2),
                                  [[0, 1], [2, 3]])
    np.testing.assert_array_equal(D.hybrid_layout([0, 0, 1, 1]),
                                  [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="uneven slices"):
        D.hybrid_layout([0, 0, 0, 1])
    with pytest.raises(ValueError, match="n_seq=3 does not divide the 4 "
                                         "devices per slice"):
        D.hybrid_layout([0] * 4 + [1] * 4, 3)
    assert not M.initialized()
    mesh = M.make_mesh()
    assert mesh.shape == {"dm": 1, "seq": 1} and mesh.coords == \
        {"dm": 0, "seq": 0}
    x = torch.arange(4.0)
    assert mesh.psum(x, "seq") is x and mesh.all_to_all(x, "dm") is x
    assert dict(mesh.inventory) == {("psum", ("seq",)): 1,
                                    ("all_to_all", ("dm",)): 1}
    with pytest.raises(ValueError, match="needs a process group"):
        M.Mesh(np.arange(2).reshape(2, 1))


def test_two_hosts_two_ranks(runs):
    """The reference's two-process test on "two hosts x two ranks": each
    seq row on one host, dm across both, the mesh-wide sum exact, each
    host's trials, the seq-parallel FFT across the hosts at the
    reference's gate, and the replicated summaries' digest equal on
    every rank."""
    hosts = runs["hosts"]
    assert [int(h["hosts/slices"][i]) for h in hosts[:1]
            for i in range(4)] == [0, 0, 1, 1]
    for pid, h in enumerate(hosts):
        np.testing.assert_array_equal(h["hosts/mesh"], [[0, 1], [2, 3]])
        assert float(h["hosts/total"][0]) == float(h["hosts/expected"])
        assert h["hosts/local"].tolist() == [2 * (pid // 2),
                                             2 * (pid // 2) + 1]
        assert h["hosts/peaks"].shape[0] == 4
        assert np.isfinite(h["hosts/peaks"]).all()
    assert len({str(h["hosts/digest"]) for h in hosts}) == 1
    order = sorted(hosts, key=lambda h: int(h["hosts/fft_index"]))
    got = np.concatenate([h["hosts/fft"] for h in order])
    x = fft_input("c2c", 10)
    np.testing.assert_allclose(got, np.fft.fft(x).astype(np.complex64),
                               rtol=2e-3, atol=2e-2 * 1024 ** 0.5)


def test_world_one_group_runs_the_sharded_step(runs, tmp_path):
    """A world-1 group with ``SRTB_DIST_ROWS_IMPL=pallas`` (the card's
    ``a8a`` phase, on gloo here): ``DMSearchPipeline`` runs the sharded
    step at (1, 1) with the B6 legs (their plain version here), every
    collective on the group, and its records are the one card's step's
    (the best DM, counts and zero counts exactly, the peaks at the
    gate)."""
    from srtb_tpu_torch.pipeline.runtime import DMSearchPipeline
    got = runs["single"][0]
    assert bool(got["search/sharded"])
    assert str(got["search/legs"]) == "pallas_interpret"
    segments = int(got["search/segments"])
    assert segments == 3
    assert got["search/inventory"].tolist() == [
        f"all_to_all seq {3 * segments}", f"ppermute seq {2 * segments}",
        f"psum dm {3 * segments}", f"psum seq {3 * segments}"]
    cfg = Config(**runs["search_cfg"]).replace(
        baseband_output_file_prefix=f"{tmp_path}/one_")
    with DMSearchPipeline(cfg, device="cpu") as search:
        assert not search.processor.sharded
        search.run()
    with open(search.trials_path) as f:
        want = [json.loads(line) for line in f if line.strip()]
    records = [json.loads(line) for line in got["search/records"].tolist()]
    assert len(records) == len(want) == segments
    for g, e in zip(records, want):
        for key in ("best_dm", "signal_counts", "zero_counts"):
            assert g[key] == e[key], key
        np.testing.assert_allclose(g["peak_snr"], e["peak_snr"], **PEAK_TOL)


# ---------------------------------------------------------- the CLI

def _cli(argv: list, rank: int, world: int, rendezvous: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env.update({"OMP_NUM_THREADS": "1"})
    return subprocess.Popen(
        [sys.executable, "-m", "srtb_tpu_torch.tools.main", *argv,
         "--device", "cpu", "--distributed_coordinator", rendezvous,
         "--distributed_num_processes", str(world),
         "--distributed_process_id", str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_cli_dm_search_on_two_processes(tmp_path):
    """``srtb-torch-main --device cpu --dm_list ...`` at two processes
    (gloo): the trials sharded over both ranks, the records of rank 0
    equal to the reference's ``DMSearchPipeline`` records at the gates
    (the exact fields exact, the S/Ns at the peak gate), and rank 1 wrote
    none."""
    d = tmp_path / "cli"
    d.mkdir()
    argv, _nres = make_case(d)
    argv += ["--dm_list", " -0.3, -0.2, -0.1, 0",
             "--baseband_output_file_prefix", f"{d}/dm_"]
    cfg = Config.from_args(argv)
    ref_cfg = cfg.replace(baseband_output_file_prefix=f"{d}/ref_")
    (tmp_path / "ref_dir").mkdir()
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, [{
            "key": "pipe", "fn": "test_torch_ref:dm_search_pipeline",
            "args": [dataclasses.asdict(ref_cfg)]}], tmp_path / "ref_dir")
        rdzv = f"file://{tmp_path}/cli_rendezvous"
        procs = [_cli(argv, r, 2, rdzv) for r in range(2)]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        want = ref.result()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "dm search done: 3 segments" in outs[0]
    with open(cfg.baseband_output_file_prefix + "dm_trials.jsonl") as f:
        got = [json.loads(line) for line in f if line.strip()]
    exp = [json.loads(line) for line in want["pipe/records"].tolist()]
    assert len(got) == len(exp) == 3  # rank 1 appended nothing
    for g, e in zip(got, exp):
        assert list(g) == list(e)
        for key in ("segment", "best_dm", "dm_list", "signal_counts",
                    "zero_counts"):
            assert g[key] == e[key], key
        np.testing.assert_allclose(g["peak_snr"], e["peak_snr"], **PEAK_TOL)
        np.testing.assert_allclose(g["best_snr"], e["best_snr"], **PEAK_TOL)


def test_a_missing_rank_fails_its_peer(tmp_path):
    """A group asked for whose other rank never comes raises at the
    timeout instead of hanging (gloo, a 2 s timeout)."""
    code = ("import sys; from srtb_tpu_torch.parallel import distributed "
            "as D\ntry:\n    D.initialize(sys.argv[1], 2, 0, device='cpu', "
            "timeout_s=2)\nexcept Exception as e:\n    print('RAISED', "
            "type(e).__name__)\n    sys.exit(3)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code,
                           f"file://{tmp_path}/lonely"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout


def test_the_card_asks_for_nccl_and_no_other(monkeypatch):
    """On a CUDA device ``initialize`` asks for NCCL and nothing else: a
    group that fails to form raises, with no second try on gloo or the
    CPU (the backend and device are checked without a card)."""
    calls = []

    def failing(backend, **kwargs):
        calls.append((backend, kwargs.get("device_id")))
        raise RuntimeError("NCCL: no group")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(D.dist, "init_process_group", failing)
    with pytest.raises(RuntimeError, match="NCCL: no group"):
        D.initialize("127.0.0.1:1", 2, 1)
    assert calls == [("nccl", torch.device("cuda", 0))]

"""Micro-batch (``micro_batch_segments`` = B > 1) in the port against the
JAX package.

The processor's batch steps, ``process_batch``, ``process_batch_cold``
and ``process_batch_ring``, against the reference's (its fused plan
vmapped over the batch, Pallas in interpret mode) at B = 2 and 3 on
``fused:monolithic``, a ``pallas`` plan, a ``pallas2`` plan and two
streams: ``signal_counts`` and ``zero_count`` exact, the waterfall and
time series within the reference's vmap tolerance (rtol 1e-5, atol 1e-4
max(|golden|, 1)); each lane bit-identical to the port's own single
dispatch of that segment.  Then the engine: ``srtb-torch-main
--micro_batch_segments 2 --inflight_segments 4`` against ``srtb-main`` on
the same arguments, the run-start refusals, the tail rule, the ingest
ring's upload model and the checkpoint's per-segment offsets."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline import runtime as R
from srtb_tpu_torch.pipeline import segment as seg
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.tools import main as M
from srtb_tpu_torch.utils.bufferpool import BufferPool
from test_torch_pipeline import (check_candidate_contents, make_case,
                                 reference_arrays)
from test_torch_ref import run_reference
from test_torch_segment import CASES, SHAPES

# (segment case of test_torch_segment, B)
BATCH_CASES = {
    "monolithic": ("n16_ch32", 2),
    "pallas": ("n16_ch4_skzap", 3),
    "pallas2": ("n16_ch4_pallas2", 2),
    "two_streams": ("is2_2bit_pallas", 2),
}
ENGINE_ARGV = ["--micro_batch_segments", "2", "--inflight_segments", "4"]


def batch_inputs(name: str, b: int):
    """From the case's segment bytes, a stream of 2B overlapping
    segments: the cold batch is segments 0 .. B-1 (``raws [B, bytes]``),
    the warm batch after it segments B .. 2B-1 as B strides of new bytes
    (``news [B, stride]``) behind the cold batch's carry."""
    cfg, raw, window, staged, env = CASES[name]
    sp = SegmentProcessor(cfg, window_name=window, device="cpu")
    stride, res = sp.stride_bytes, sp.reserved_bytes
    rng = np.random.default_rng(len(name) + b)
    stream = np.concatenate([raw, rng.integers(
        0, 256, 2 * b * stride + res - raw.size, dtype=np.uint8)])
    segs = np.stack([stream[i * stride:i * stride + raw.size]
                     for i in range(2 * b)])
    news = segs[b:, res:]
    return sp, segs, news


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_batch")
    jobs = []
    for key, (name, b) in BATCH_CASES.items():
        cfg, _raw, window, _staged, env = CASES[name]
        _sp, segs, news = batch_inputs(name, b)
        jobs.append({"key": key, "fn": "test_torch_ref:segment_batch",
                     "args": [dataclasses.asdict(cfg), segs[:b], news,
                              window, env]})
    argv, _nres = make_case(tmp)
    out = tmp / "engine_ref"
    out.mkdir()
    jobs.append({"key": "engine", "fn": "test_torch_ref:pipeline_main",
                 "args": [argv + ENGINE_ARGV + [
                     "--baseband_output_file_prefix", f"{out}/out_"],
                     str(out)]})
    return {"ref": run_reference(jobs, tmp), "tmp": tmp, "argv": argv}


def _lanes_close(lanes, want_ri, want_det, b):
    """Each lane against the reference's batch at the vmap tolerance,
    the decisions exact."""
    assert len(lanes) == b
    for i, (wf, res) in enumerate(lanes):
        np.testing.assert_array_equal(res.signal_counts.numpy(),
                                      want_det["signal_counts"][i])
        np.testing.assert_array_equal(res.zero_count.numpy(),
                                      want_det["zero_count"][i])
        want = want_ri[i, 0] + 1j * want_ri[i, 1]
        np.testing.assert_allclose(
            wf.numpy(), want, rtol=1e-5,
            atol=1e-4 * max(float(np.abs(want).max()), 1.0))
        ts = want_det["time_series"][i]
        np.testing.assert_allclose(
            res.time_series.numpy(), ts, rtol=1e-5,
            atol=1e-4 * max(float(np.abs(ts).max()), 1.0))


def _ref_part(ref, key, part):
    det = {f: ref[f"{key}/{part}/detect/{f}"]
           for f in ("signal_counts", "zero_count", "time_series")}
    return ref[f"{key}/{part}/wf_ri"], det


def _same_bits(lane, single):
    wf, res = lane
    wf1, res1 = single
    assert torch.equal(wf, wf1)
    for a, c in zip(res, res1):
        assert torch.equal(a, c) if isinstance(a, torch.Tensor) else a == c


@pytest.mark.parametrize("key", sorted(BATCH_CASES))
def test_batch_steps_match_reference(ref, key):
    """process_batch, process_batch_cold and process_batch_ring against
    the reference's on the same bytes, the plan the reference's, and the
    carries equal byte for byte."""
    ref = ref["ref"]
    name, b = BATCH_CASES[key]
    sp, segs, news = batch_inputs(name, b)
    assert sp.plan_name == str(ref[f"{key}/plan"]) == SHAPES[name][6]
    _lanes_close(sp.process_batch(segs[:b]), *_ref_part(ref, key, "batch"),
                 b)
    lanes, carry = sp.process_batch_cold(segs[:b])
    _lanes_close(lanes, *_ref_part(ref, key, "cold"), b)
    np.testing.assert_array_equal(carry.numpy(), ref[f"{key}/cold/carry"])
    lanes, carry = sp.process_batch_ring(carry, news)
    _lanes_close(lanes, *_ref_part(ref, key, "ring"), b)
    np.testing.assert_array_equal(carry.numpy(), ref[f"{key}/ring/carry"])


@pytest.mark.parametrize("key", sorted(BATCH_CASES))
def test_lanes_are_single_dispatches(key):
    """Every lane of every batch step gives the bits the port's single
    dispatch of that segment gives; stage_batch's warm window holds the
    segments' own bytes."""
    name, b = BATCH_CASES[key]
    sp, segs, news = batch_inputs(name, b)
    singles = [sp.process(seg) for seg in segs]
    for lane, single in zip(sp.process_batch(segs[:b]), singles):
        _same_bits(lane, single)
    lanes, carry = sp.process_batch_cold(segs[:b])
    for lane, single in zip(lanes, singles):
        _same_bits(lane, single)
    window = sp.stage_batch(list(segs[b:]), carry=carry)
    assert window.numel() == sp.reserved_bytes + b * sp.stride_bytes
    lanes, _ = sp.run_batch_ring(window)
    for lane, single in zip(lanes, singles[b:]):
        _same_bits(lane, single)


def test_batch_shape_and_plan_refusals():
    """The reference's ValueErrors: a batch not [B, bytes], and a batch
    on the staged plan."""
    name, _b = BATCH_CASES["monolithic"]
    cfg, raw, *_ = CASES[name]
    sp = SegmentProcessor(cfg, device="cpu")
    with pytest.raises(ValueError, match="batch must be"):
        sp.process_batch(np.zeros((2, 7), np.uint8))
    staged = SegmentProcessor(cfg, device="cpu", staged=True)
    with pytest.raises(ValueError, match="fused plan"):
        staged.process_batch(np.stack([raw, raw]))
    with pytest.raises(ValueError, match="fused plan"):
        staged.stage_batch([raw, raw])


@pytest.fixture(scope="module")
def engine(ref):
    tmp, argv = ref["tmp"], ref["argv"]
    runs = {}
    for tag, extra in (("b1", []), ("b2", ENGINE_ARGV)):
        out = tmp / f"engine_{tag}"
        out.mkdir()
        runs[tag] = (out, *M.run(argv + extra + [
            "--baseband_output_file_prefix", f"{out}/out_",
            "--device", "cpu"]))
    return runs


def test_engine_writes_the_references_candidates(ref, engine):
    """``srtb-torch-main --micro_batch_segments 2 --inflight_segments 4``
    writes the artifacts ``srtb-main`` writes on the same arguments (names
    and ``.bin`` bytes exact, the waterfall and series within the pipeline
    test's gates), and byte for byte what the port writes without the
    batch."""
    r = ref["ref"]
    out, stats, pipe = engine["b2"]
    assert int(r["engine/rc"]) == 0
    names = sorted(os.listdir(out))
    assert names == r["engine/files"].tolist()
    assert stats.segments == 3 and pipe.positive_segments == [1]
    ref_dir = ref["tmp"] / "engine_ref"
    for name in names:
        if name.endswith(".bin"):
            assert (out / name).read_bytes() == (ref_dir / name).read_bytes()
    (files,) = pipe.sink.written
    check_candidate_contents(files, reference_arrays(r, "engine", "npy"),
                             reference_arrays(r, "engine", "tim"),
                             pipe.processor.nsamps_reserved)
    out1 = engine["b1"][0]
    assert sorted(os.listdir(out1)) == names
    for name in names:
        assert (out / name).read_bytes() == (out1 / name).read_bytes()


def test_tail_rule_and_ring_uploads(engine):
    """3 segments at B = 2: one batch (cold, two whole segments) and one
    single warm dispatch; the H2D bytes follow the stride model (the
    reference's tests/test_ring.py)."""
    _out, stats, pipe = engine["b2"]
    proc = pipe.processor
    ex = stats.extras
    assert ex["micro_batch_segments"] == 2 and ex["dispatches"] == 2
    seg, stride = proc.stride_bytes + proc.reserved_bytes, proc.stride_bytes
    assert ex["h2d_bytes_per_segment"] == [seg, seg, stride]
    assert proc.ring_cold_dispatches == 1
    _out1, stats1, _pipe1 = engine["b1"]
    assert stats1.extras["dispatches"] == 3


@pytest.mark.parametrize("ring", ["auto", "off"])
def test_ring_on_and_off_change_uploads_only(tmp_path, ring):
    """Ring on against off under micro-batch: the same bytes written, the
    H2D bytes ``2 segments + (n - 2) strides`` with the ring (one cold
    batch), ``n segments`` without."""
    argv, _nres = make_case(tmp_path)
    outs = {}
    for tag, extra in (("b1", []), ("b2", ENGINE_ARGV)):
        out = tmp_path / tag
        out.mkdir()
        stats, pipe = M.run(argv + extra + [
            "--ingest_ring", ring, "--baseband_output_file_prefix",
            f"{out}/out_", "--device", "cpu"])
        outs[tag] = {n: (out / n).read_bytes() for n in os.listdir(out)}
    assert outs["b1"] == outs["b2"]
    proc = pipe.processor
    seg = proc.stride_bytes + proc.reserved_bytes
    h2d = sum(stats.extras["h2d_bytes_per_segment"])
    if ring == "auto":
        assert h2d == 2 * seg + (stats.segments - 2) * proc.stride_bytes
        assert proc.ring_cold_dispatches == 1
    else:
        assert h2d == stats.segments * seg
        assert proc.ring_cold_dispatches == 0


class _Unread:
    """A source that fails any read: the refusals must come first."""
    pool = BufferPool("unread")

    def __iter__(self):
        return self

    def __next__(self):
        raise AssertionError("the source was read")

    def close(self):
        pass


@pytest.mark.parametrize("case", ["exceeds_window", "staged"])
def test_run_refuses_before_any_read(tmp_path, monkeypatch, case):
    """B above the window raises "exceeds", B > 1 on the staged plan
    "fused plan" (the plan forced at this size, as the reference's tests
    force it), both before the first read."""
    argv, _nres = make_case(tmp_path)
    over = {"exceeds_window": ["--micro_batch_segments", "4",
                               "--inflight_segments", "2"],
            "staged": ENGINE_ARGV}[case]
    cfg = Config.from_args(argv + over + [
        "--baseband_output_file_prefix", f"{tmp_path}/out_"])
    if case == "staged":
        monkeypatch.setattr(seg, "STAGED_MIN_N", cfg.baseband_input_count)
    with R.Pipeline(cfg, source=_Unread(), device="cpu") as pipe:
        assert pipe.processor.staged == (case == "staged")
        with pytest.raises(ValueError, match={
                "exceeds_window": "exceeds",
                "staged": "fused plan"}[case]):
            pipe.run()


def _checkpoint_updates(tmp_path, tag, extra):
    argv, _nres = make_case(tmp_path)
    out = tmp_path / tag
    out.mkdir()
    cfg = Config.from_args(argv + extra + [
        "--baseband_output_file_prefix", f"{out}/out_",
        "--checkpoint_path", str(out / "ck.json"),
        "--writer_thread_count", "0"])
    pipe = R.Pipeline(cfg, device="cpu")
    updates = []
    orig = pipe.checkpoint.update
    pipe.checkpoint.update = lambda done, off: (
        updates.append((done, off)), orig(done, off))
    with pipe:
        stats = pipe.run(max_segments=3)
    assert stats.segments == 3
    return updates, pipe


def test_checkpoint_offsets_are_per_segment(tmp_path):
    """Each drained segment checkpoints the source offset after its own
    read, not the batch's (the reference's tests/test_overlap.py): at
    B = 2 the updates are B = 1's, one a segment, the first at one stride
    (the reader had read two segments when the batch dispatched), so a
    crash inside a batch resumes at its first undrained segment."""
    single, _pipe = _checkpoint_updates(tmp_path, "b1", [])
    batched, pipe = _checkpoint_updates(tmp_path, "b2", ENGINE_ARGV)
    assert batched == single
    assert [done for done, _off in batched] == [1, 2, 3]
    assert batched[0][1] == pipe.processor.stride_bytes
    assert batched[1][1] == 2 * pipe.processor.stride_bytes

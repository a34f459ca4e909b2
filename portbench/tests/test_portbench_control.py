"""The comparison that decides ``correct`` fails where it must.

Each test drives a whole run of a cell at a small size on the CPU, past
the harness's look for a card: the sound program passes; the control
(the reference in bfloat16 in the program's place) fails; and so does
the program with its timed path broken underneath: an answer altered
where it is produced, half of each segment left out, and a stale answer
(the engine handing out the previous segment's detection unchanged).
The limits are the cells' own (``portbench/limits``).

The size: 2^20 samples and 2^8 channels, and a pulse of amplitude 6, so
that the pulse is found and the SK stage does not zap it, as at the
cells' size with the cells' amplitude.
"""

from __future__ import annotations

import pytest
import torch

from portbench import run

SMALL = {"baseband_input_count": "2 ** 20",
         "spectrum_channel_count": "2 ** 8", "log_level": 1}
MIX = {"pulse_amp": 6.0, "positives": {"count": 2, "index_range": [2, 6]},
       "pool_segments": 4, "warmup_segments": 2,
       "check": {"pulsed": 2, "noise": 3}}
CELLS = ("j1644.replay", "j1644_dm8.replay")


def _run(cell: str, seed: int, control: bool = False) -> dict:
    run.set_environment()
    mix = dict(MIX)
    if cell == "j1644_dm8.replay":
        mix.pop("positives")
        mix["pool_pulse_every"] = 2
    return run.run_cell(cell, seed, 5.0, False, torch.device("cpu"),
                        overrides=SMALL, control=control,
                        traffic_overrides=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    r = _run(cell, 11)
    assert r["correct"], r["checks"]
    assert r["_info"]["compared"] >= 2
    assert r["checks"]["verdict_mismatch"][0] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = _run(cell, 12, control=True)
    assert not r["correct"], r["checks"]


def _alter_answer(monkeypatch):
    from srtb_tpu_torch.ops import detect as D
    orig = D.count_signal

    def altered(x, snr_threshold):
        count, peak = orig(x, snr_threshold)
        return count, peak * 1.01
    monkeypatch.setattr(D, "count_signal", altered)


def _half_left_out(monkeypatch):
    from srtb_tpu_torch.pipeline import segment as S
    orig = S.SegmentProcessor._unpack

    def half(self, raw):
        x = orig(self, raw)
        x[..., x.shape[-1] // 2:] = 1.5
        return x
    monkeypatch.setattr(S.SegmentProcessor, "_unpack", half)


def _stale_answer(monkeypatch):
    from srtb_tpu_torch.ops import detect as D
    orig = D.detect_from_time_series
    last = {}

    def stale(*a, **k):
        out = last.get("r") or orig(*a, **k)
        last["r"] = out
        return out
    monkeypatch.setattr(D, "detect_from_time_series", stale)
    from srtb_tpu_torch.pipeline import segment as S
    monkeypatch.setattr(S.det, "detect_from_time_series", stale)


@pytest.mark.parametrize("fault", [_alter_answer, _half_left_out,
                                   _stale_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell, 13)
    assert not r["correct"], r["checks"]

"""The port's metrics registry (``srtb_tpu_torch/utils/metrics.py``)
against the JAX package's: the same scripted sequence of ``add``,
``set``, ``histogram().observe`` and ``window().add``, with labels and
a fake clock, through both registries (the reference's in its own
interpreter, ``tests/test_torch_ref.py``).  The snapshots must be equal,
the Prometheus text equal byte for byte and the interpolated quantiles
equal exactly.  Then the registry's own contract: ``get`` and
``by_label``, first-caller buckets and windows, ``reset``, the window
rate and the escaping of label values."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from srtb_tpu_torch.utils import metrics as M
from test_torch_ref import metrics_script, run_reference

TIME = None  # the default DEFAULT_TIME_BUCKETS

SCRIPTS = {
    # the pipeline's own families: counters with stream twins, the
    # derived packet-loss and Msamples/s series, per-stage histograms,
    # windows, and device-labeled series (the _pool_sum/_pool_max twins)
    "pipeline": [
        ("add", "segments", 1.0, None), ("add", "samples", 65536.0, None),
        ("add", "segments", 1.0, {"stream": "beam3"}),
        ("add", "packets_total", 1000.0, None),
        ("add", "packets_lost", 7.0, None),
        ("add", "packets_lost", 7.0, {"stream": "beam3"}),
        ("window", "packets_total", 1000.0, 10.0),
        ("window", "packets_lost", 7.0, 10.0),
        ("window", "segments", 1.0, 10.0),
        ("tick", 0.5),
        ("observe", "stage_seconds", 0.0031, {"stage": "ingest"}, TIME),
        ("observe", "stage_seconds", 0.012, {"stage": "dispatch"}, TIME),
        ("observe", "stage_seconds", 0.0042, {"stage": "ingest"}, TIME),
        ("observe", "device_seconds", 0.25, None, TIME),
        ("observe", "device_seconds", 150.0, None, TIME),
        ("set", "inflight_depth", 2.0, None),
        ("set", "achieved_gbps", 1234.5678, {"device": "dev0"}),
        ("set", "achieved_gbps", 999.0, {"device": "dev1"}),
        ("add", "retries_fetch", 2.0, None),
        ("add", "worker_restarts_sink_drain", 1.0, None),
        ("add", "my_custom_total", 3.0, None),
        ("tick", 2.0),
        ("add", "segments", 1.0, None), ("add", "samples", 65536.0, None),
        ("window", "segments", 1.0, 10.0),
        ("window", "samples", 131072.0, 5.0),
        ("tick", 12.0),
        ("window", "packets_total", 500.0, 10.0),
        ("quantile", "stage_seconds", {"stage": "ingest"}, 0.5),
        ("quantile", "stage_seconds", {"stage": "ingest"}, 0.99),
        ("quantile", "device_seconds", None, 0.95),
    ],
    # label values that must be escaped, and names that must be mangled
    "escaping": [
        ("set", "slo_state", 2.0, {"objective": "loss",
                                   "stream": 'a"b\\c\nd'}),
        ("set", "slo_burn_rate", 1.5, {"objective": "loss",
                                       "window": "fast"}),
        ("add", "weird-name.with:chars", 1.0, None),
        ("add", "degrade_level", 0.0, None),
    ],
    # a histogram of its own buckets: edges, overflow, the first bucket
    "quantile_edges": [
        ("observe", "batch_size", v, None, (1, 2, 4, 8))
        for v in (0.5, 1.0, 1.0, 2.0, 3.0, 4.0, 8.0, 9.0, 100.0)] + [
        ("quantile", "batch_size", None, q)
        for q in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)],
    "empty": [("quantile", "stage_seconds", None, 0.5)],
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": name, "fn": "test_torch_ref:metrics_script",
             "args": ["srtb_tpu", script]}
            for name, script in SCRIPTS.items()]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_metrics"))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_equals_reference(ref, name):
    """The same snapshot, the same Prometheus text byte for byte, and the
    same quantiles exactly."""
    got = metrics_script("srtb_tpu_torch", SCRIPTS[name])
    assert got["snapshot"] == str(ref[f"{name}/snapshot"])
    assert got["prometheus"] == str(ref[f"{name}/prometheus"])
    np.testing.assert_array_equal(got["quantiles"],
                                  ref[f"{name}/quantiles"])


def test_snapshot_and_prometheus_agree():
    """Every flat series of the snapshot is a sample of the Prometheus
    text, each family with one HELP and one TYPE line."""
    got = metrics_script("srtb_tpu_torch", SCRIPTS["pipeline"])
    snap = json.loads(got["snapshot"])
    lines = got["prometheus"].splitlines()
    samples = dict(line.rsplit(" ", 1) for line in lines
                   if not line.startswith("#"))
    for key in ("segments", "packet_loss_rate", "msamples_per_sec",
                "achieved_gbps_pool_sum", "achieved_gbps_pool_max"):
        assert float(samples["srtb_" + key]) == snap[key], key
    helps = [line.split()[2] for line in lines if line.startswith("# HELP")]
    assert len(helps) == len(set(helps))
    assert snap["packet_loss_rate"] == 7.0 / 1000.0
    # the loss window holds the later 500 only (the first add aged out)
    assert snap["packet_loss_rate_window"] == 0.0
    assert "# HELP srtb_my_custom_total srtb_tpu runtime metric" in lines


def test_get_labels_and_reset():
    """Flat and labeled series are apart; ``by_label`` maps the label;
    the first caller fixes buckets and window lengths; ``reset`` clears
    everything."""
    m = M.Metrics()
    m.add("segments_dropped", 2)
    m.add("segments_dropped", 1, labels={"stream": "b"})
    m.add("segments_dropped", 4, labels={"stream": "a"})
    assert m.get("segments_dropped") == 2.0
    assert m.get("segments_dropped", labels={"stream": "a"}) == 4.0
    assert m.get("missing") == 0.0
    assert m.by_label("segments_dropped") == {"a": 4.0, "b": 1.0}
    h = m.histogram("x", buckets=(1, 2))
    assert m.histogram("x", buckets=(5,)) is h and h.bounds == (1.0, 2.0)
    w = m.window("w", 3.0)
    assert m.window("w", 9.0) is w and w.window_s == 3.0
    m.reset()
    assert m.get("segments_dropped") == 0.0 and m.by_label(
        "segments_dropped") == {}
    assert set(m.snapshot()) == {"elapsed_s"}
    with pytest.raises(ValueError):
        M.Histogram("h", buckets=())
    with pytest.raises(ValueError):
        M.SlidingWindow("w", window_s=0)


def test_window_rate_and_histogram_quantiles():
    """A young window rates over its age, a full one over its length; an
    empty histogram's quantile is NaN; buckets are cumulative."""
    t = [0.0]
    w = M.SlidingWindow("w", window_s=10.0, clock=lambda: t[0])
    w.add(4.0)
    t[0] = 2.0
    assert w.rate() == 2.0 and w.sum() == 4.0
    t[0] = 20.0
    assert w.rate() == 0.0
    h = M.Histogram("h", buckets=(1.0, 2.0))
    assert math.isnan(h.quantile(0.5))
    for v in (0.5, 1.5, 1.5, 5.0):
        h.observe(v)
    assert h.cumulative_buckets() == [(1.0, 1), (2.0, 3), (math.inf, 4)]
    assert h.quantile(1.0) == 2.0 and h.quantile(0.25) == 1.0
    assert h.percentiles()["p50"] == 1.5

"""Two counters an operator reads on ``/metrics``, held to the JAX
package's (the reference runs in its own interpreter,
``tests/test_torch_ref.py``):

- ``wedged_threads``: a thread still alive after a bounded join adds one
  (``utils/termination.report_wedged``): ``framework.on_exit`` on a pipe
  that ignores its stop token, and the engine's shutdown with a sink
  wedged inside its push (the port's counterpart of the reference's
  ``test_pipeline_shutdown_join_is_bounded``) on the incident tests'
  live stand-in, whose drop accounting and journal must agree too;
- ``udp_rx{id}_queue_packets``: ``UdpReceiverSource`` with
  ``udp_packet_provider = "asyncio"`` sets it to the receiver's queue
  depth after each block.  Its value depends on timing, so it is checked
  for range, not equality; the segments' bytes are equal."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from test_torch_canary import write_noise
from test_torch_incidents import escalation_fields
from test_torch_ref import (HEALTH_COUNTERS, asyncio_gauge_script,
                            health_run, run_reference, wedged_pipe_script)
from test_torch_udp import source_config

COUNTERS = HEALTH_COUNTERS + ("wedged_threads",)
# the asyncio source case: 10 packets in order, 3 segments (the UDP
# tests' overlap case)
UDP_COUNTERS = list(range(10))
UDP_SEGMENTS = 3
UDP_SEED = 9
# AsyncioBlockReceiver's default queue bound, in packets
QUEUE_BOUND = 8192


def _udp_fields() -> dict:
    return dataclasses.asdict(source_config())


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    write_noise(tmp)
    return tmp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    tmp = tmp_path_factory.mktemp("ref_faults")
    fields, source = escalation_fields(work, "sink_wedge", "ref")
    jobs = [{"key": "pipe", "fn": "test_torch_ref:wedged_pipe_script",
             "args": ["srtb_tpu"]},
            {"key": "sink", "fn": "test_torch_ref:health_run",
             "args": ["srtb_tpu", fields],
             "kwargs": {"source_fields": source, "wedge": "sink",
                        "counters": COUNTERS}},
            {"key": "udp", "fn": "test_torch_ref:asyncio_gauge_script",
             "args": ["srtb_tpu", _udp_fields(), UDP_COUNTERS, UDP_SEED,
                      UDP_SEGMENTS]}]
    return run_reference(jobs, tmp, compile_cache=True)


def test_on_exit_counts_a_wedged_pipe(ref):
    """The join gives up within its budget, returns the pipe and counts
    one wedged thread, as the reference's does."""
    got = wedged_pipe_script("srtb_tpu_torch")
    assert got["bounded"] and got["joined"]
    assert got["wedged"] == [True]
    assert got["wedged_threads"] == 1
    assert ref["pipe/wedged_threads"] == 1
    assert bool(ref["pipe/bounded"]) and list(ref["pipe/wedged"]) == [True]


def test_a_wedged_sink_counts_and_accounts_as_the_reference(ref, work):
    """The engine's bounded sink join on a wedged sink: at least one
    wedged thread in both packages, and the same drops, journal lines,
    segments and error."""
    fields, source = escalation_fields(work, "sink_wedge", "port")
    got = health_run("srtb_tpu_torch", fields, source_fields=source,
                     wedge="sink", counters=COUNTERS)
    c = dict(zip(COUNTERS, got["counters"]))
    r = dict(zip(COUNTERS, ref["sink/counters"]))
    assert c["wedged_threads"] >= 1
    assert r["wedged_threads"] >= 1
    assert c["segments_dropped"] == r["segments_dropped"]
    assert list(got["spans"]) == list(ref["sink/spans"])
    assert got["segments"] == ref["sink/segments"]
    assert got["error"] == str(ref["sink/error"])


def test_asyncio_source_sets_the_queue_gauge(ref):
    """``udp_rx0_queue_packets`` is on both scrapes (as
    ``srtb_udp_rx0_queue_packets``), an integer in [0, the queue's
    bound]; the segments are the reference's bytes."""
    got = asyncio_gauge_script("srtb_tpu_torch", _udp_fields(),
                               UDP_COUNTERS, UDP_SEED, UDP_SEGMENTS)
    for lines, value in ((got["lines"], got["gauge"]),
                         (ref["udp/lines"], ref["udp/gauge"])):
        names = [str(line).split()[0] for line in lines if str(line)]
        assert "srtb_udp_rx0_queue_packets" in names
        assert float(value) == int(value) and 0 <= value <= QUEUE_BOUND
    for field in ("data", "counter", "seq"):
        np.testing.assert_array_equal(got["0"][field], ref[f"udp/0/{field}"])


def test_queue_depth_is_the_queue_under_its_lock():
    """``AsyncioBlockReceiver.queue_depth`` counts the packets waiting
    between the event loop and the assembler."""
    from srtb_tpu_torch.io import udp
    from test_torch_ref import free_udp_port
    fmt = udp.formats.resolve(source_config().baseband_format_type)
    rx = udp.AsyncioBlockReceiver("127.0.0.1", free_udp_port(), fmt)
    try:
        assert rx.queue_depth() == 0
        with rx._cv:
            rx._q.extend([b"a", b"b"])
        assert rx.queue_depth() == 2
    finally:
        rx.close()

"""The benchmark's own segment sources, in place of the program's file
and UDP readers, so that neither the disk nor the NIC limits the input.

:class:`SegmentBank` holds every byte a run hands out, pinned on the
host: a pool of noise segments read cyclically, and the segments that
carry a dispersed pulse, all made on the device from the run's seed.
:class:`ReplaySource` is the closed loop: the next segment as soon as the
engine asks.  :class:`PacedSource` is an open loop's (no cell runs one
yet): segment k of a stream is due when its last sample would have
arrived, and is handed out no earlier, on a schedule that does not slow
when the engine does.

Both hand out the program's ``SegmentWork`` with the stream's sample
time as its timestamp and a ``bench_key`` (stream, index) of their own,
and advance ``logical_offset`` as a file reader does.  Their ``pool`` is
a no-op: the bytes are views of the bank, which outlives the run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import synth

# the sample-time stamps' epoch (any fixed instant: only differences matter)
EPOCH_NS = 1_700_000_000_000_000_000


class _NullPool:
    """The engine gives each segment's buffer back here: the bank keeps
    them, so there is nothing to do."""

    def release(self, buf) -> None:
        pass

    def free_all(self) -> int:
        return 0


def segment_bytes(cfg) -> int:
    return cfg.baseband_input_count * abs(cfg.baseband_input_bits) // 8


class SegmentBank:
    """The run's input, made on ``device`` from ``seed`` and copied to
    host memory (pinned, on the card): ``n_pool`` pool segments, those in
    ``pool_pulses`` ({slot: sample position}) with a dispersed pulse, the
    rest noise; and the segments ``extra`` ({(stream, index): sample
    position}), each with a pulse of its own."""

    def __init__(self, cfg, n_pool: int, seed: int, pulse_amp: float,
                 device: torch.device, pool_pulses: dict | None = None,
                 extra: dict | None = None):
        self.cfg = cfg
        self.nbytes = segment_bytes(cfg)
        self.n_pool = n_pool
        self.pool_pulses = dict(pool_pulses or {})
        self.extra_pulses = dict(extra or {})
        pinned = device.type == "cuda"
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2 ** 63))
        slab = torch.empty(n_pool * self.nbytes, dtype=torch.uint8,
                           pin_memory=pinned)
        for i in range(n_pool):
            chunk = self._make(self.pool_pulses.get(i), pulse_amp, device,
                               gen)
            slab[i * self.nbytes:(i + 1) * self.nbytes].copy_(chunk)
        self.pool = slab.numpy().reshape(n_pool, self.nbytes)
        self._slab = slab
        self.pulsed: dict = {}
        for key in sorted(self.extra_pulses):
            host = torch.empty(self.nbytes, dtype=torch.uint8,
                               pin_memory=pinned)
            host.copy_(self._make(self.extra_pulses[key], pulse_amp, device,
                                  gen))
            self.pulsed[key] = host.numpy()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _make(self, position, pulse_amp, device, gen) -> torch.Tensor:
        cfg = self.cfg
        if position is None:
            return synth.make_noise_bytes(self.nbytes,
                                          cfg.baseband_input_bits,
                                          device=device, generator=gen)
        return synth.make_dispersed_baseband(
            cfg.baseband_input_count, cfg.baseband_freq_low,
            cfg.baseband_bandwidth, cfg.dm, [position],
            nbits=cfg.baseband_input_bits, pulse_amp=pulse_amp,
            device=device, generator=gen)

    def slot(self, stream: int, index: int) -> int:
        return (index + 7 * stream) % self.n_pool

    def bytes_of(self, stream: int, index: int) -> np.ndarray:
        """Segment ``index`` of ``stream``: its own pulsed bytes, or a
        segment of the pool (each stream from its own offset)."""
        key = (stream, index)
        if key in self.pulsed:
            return self.pulsed[key]
        return self.pool[self.slot(stream, index)]

    def is_pulsed(self, stream: int, index: int) -> bool:
        return ((stream, index) in self.pulsed
                or self.slot(stream, index) in self.pool_pulses)

    def segment_ns(self) -> int:
        return round(self.cfg.baseband_input_count * 1e9
                     / self.cfg.baseband_sample_rate)


def make_work(bank: SegmentBank, stream: int, index: int):
    from srtb_tpu_torch.pipeline.work import SegmentWork
    work = SegmentWork(data=bank.bytes_of(stream, index),
                       timestamp=EPOCH_NS + index * bank.segment_ns(),
                       seq=index, data_stream_id=0)
    work.bench_key = (stream, index)
    return work


class ReplaySource:
    """Closed loop, one stream: a continuous recording read as fast as the
    engine takes it.  :meth:`arm` sets the next phase: the first index,
    and a count or a deadline (on ``clock``) after which it ends."""

    def __init__(self, bank: SegmentBank, stream: int = 0,
                 clock=time.perf_counter):
        self.bank = bank
        self.stream = stream
        self.clock = clock
        self.pool = _NullPool()
        self.logical_offset = 0
        self.handed: dict = {}
        # (time, index handed out or None at the end) of every request
        self.asks: list = []
        self.arm(0, count=0)

    def arm(self, first: int, count: int | None = None,
            deadline: float | None = None) -> None:
        self._next = first
        self._left = count
        self._deadline = deadline

    @property
    def next_index(self) -> int:
        return self._next

    def __iter__(self):
        return self

    def __next__(self):
        now = self.clock()
        if (self._left is not None and self._left <= 0) or (
                self._deadline is not None and now >= self._deadline):
            self.asks.append((now, None))
            raise StopIteration
        k = self._next
        self._next += 1
        if self._left is not None:
            self._left -= 1
        self.asks.append((now, k))
        self.handed[k] = now
        self.logical_offset += self.bank.nbytes
        return make_work(self.bank, self.stream, k)

    def completions(self) -> dict:
        """For an engine that asks for the next segment only once the last
        is done (the DM search's serial loop): each segment's completion
        is the next request after it was handed out."""
        done = {}
        for (t0, k), (t1, _) in zip(self.asks, self.asks[1:]):
            if k is not None:
                done[k] = t1
        return done

    def close(self) -> None:
        pass


class PacedSource:
    """Open loop, one stream of several: segment k is due at ``t_start +
    phase_s + (k + 1) * period_s``, when its last sample would arrive; a
    request before that waits for it, a later one gets it at once.  It
    ends with the last segment due by ``t_end``."""

    def __init__(self, bank: SegmentBank, stream: int, period_s: float,
                 phase_s: float, t_start: float, t_end: float,
                 first: int = 0, clock=time.perf_counter,
                 sleep=time.sleep):
        self.bank = bank
        self.stream = stream
        self.period_s = period_s
        self.phase_s = phase_s
        self.t_start = t_start
        self.t_end = t_end
        self.clock = clock
        self.sleep = sleep
        self.pool = _NullPool()
        self.logical_offset = 0
        self._next = first
        self._first = first
        self.due: dict = {}
        self.taken: dict = {}

    def due_time(self, k: int) -> float:
        return (self.t_start + self.phase_s
                + (k - self._first + 1) * self.period_s)

    def __iter__(self):
        return self

    def __next__(self):
        k = self._next
        due = self.due_time(k)
        if due > self.t_end:
            raise StopIteration
        wait = due - self.clock()
        if wait > 0:
            self.sleep(wait)
        self._next += 1
        self.due[k] = due
        self.taken[k] = self.clock()
        self.logical_offset += self.bank.nbytes
        return make_work(self.bank, self.stream, k)

    def close(self) -> None:
        pass

"""Running-mean 1-bit quantizer (port of ``srtb_tpu/ops/running_mean.py``,
ref: algorithm/running_mean.hpp:30-80).

Per channel: compare each sample against a sliding-window mean that
trails it by ``windowsize`` samples, emit 1 bit (sample > mean), and carry
the running mean across calls.  The recurrence is sequential in time; each
step runs over every channel at once (float32, as the reference's scan).
No path of ``srtb-torch-main`` calls it.
"""

from __future__ import annotations

import numpy as np
import torch


def running_mean_init_average(data: torch.Tensor,
                              windowsize: int) -> torch.Tensor:
    """Initial per-channel average over the first window
    (ref: running_mean.hpp:61-78).  ``data`` is [nsamp, nchan]."""
    return torch.mean(data[:windowsize].to(torch.float32), dim=0)


def running_mean(data: torch.Tensor, windowsize: int, ave: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[nsamp, nchan] samples -> ([nsamp, nchan] uint8 1-bit output, the
    final average).

    The reference's two phases: output row i compares row i against the
    average after rows < i + windowsize, which then moves by
    (tail - head) / windowsize; the last ``windowsize`` rows take their
    tails mirrored from the end (ref: running_mean.hpp:41-57)."""
    nsamp = data.shape[0]
    x = data.to(torch.float32)
    ave = ave.to(torch.float32)
    out = torch.empty(data.shape, dtype=torch.uint8, device=data.device)
    for i in range(windowsize, nsamp):
        head, tail = x[i - windowsize], x[i]
        out[i - windowsize] = (head > ave).to(torch.uint8)
        ave = ave + (tail - head) / windowsize
    for i in range(windowsize):
        head, tail = x[nsamp + i - windowsize], x[nsamp - i - 1]
        out[nsamp - windowsize + i] = (head > ave).to(torch.uint8)
        ave = ave + (tail - head) / windowsize
    return out, ave


def running_mean_oracle(data: np.ndarray, windowsize: int,
                        ave: np.ndarray):
    """Direct float64 transliteration for tests."""
    nsamp, nchan = data.shape
    out = np.zeros_like(data, dtype=np.uint8)
    ave = ave.astype(np.float64).copy()
    x = data.astype(np.float64)
    for j in range(nchan):
        a = ave[j]
        for i in range(windowsize, nsamp):
            head = x[i - windowsize, j]
            tail = x[i, j]
            out[i - windowsize, j] = head > a
            a += (tail - head) / windowsize
        for i in range(windowsize):
            head = x[nsamp + i - windowsize, j]
            tail = x[nsamp - i - 1, j]
            out[i + nsamp - windowsize, j] = head > a
            a += (tail - head) / windowsize
        ave[j] = a
    return out, ave

"""Offline two-file cross-correlator (port of
``srtb_tpu/tools/correlator.py``, ref: src/correlator.cpp:35-152;
``srtb-torch-correlator``).

corr = |iFFT(n^-1.5 · F1 · conj F2)| over the first n/2 bins of each
real FFT, n the shorter file's sample count, written as raw
little-endian float32 (byte-compatible with the reference's
``corr.bin``).  The reference runs XLA here, so the port runs
``torch.fft`` (cuFFT on the card).  A delay of the second file by L
samples puts the peak at index ``(n - L) / 2``: the output's lags step by
two samples.

Usage:
  srtb-torch-correlator [POL_1 [POL_2 [OUT]]] [--device cpu]
(defaults ``pol_1.bin``, ``pol_2.bin``, ``/dev/shm/corr.bin``)
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from srtb_tpu_torch.utils.device import resolve_device
from srtb_tpu_torch.utils.logging import log


def correlate_device(a: torch.Tensor, b: torch.Tensor,
                     input_size: int | None = None) -> torch.Tensor:
    """The correlation of two sample tensors of equal even length (any
    real dtype, on one device): float32 [length/2] on their device,
    normalized by ``input_size`` (the shorter file's sample count, which
    may be one more than the length; default the length)."""
    complex_count = a.shape[-1] // 2
    norm = np.float32((input_size or a.shape[-1]) ** -1.5)
    fa = torch.fft.rfft(a.to(torch.float32))[:complex_count]
    fb = torch.fft.rfft(b.to(torch.float32))[:complex_count]
    prod = (norm * fa) * torch.conj(fb)
    del fa, fb
    # unnormalized backward C2C, like the reference's BACKWARD plan
    return torch.abs(torch.fft.ifft(prod, norm="forward"))


def correlate(x1: np.ndarray, x2: np.ndarray, device=None) -> np.ndarray:
    """Cross-correlation magnitude of two 8-bit sample streams
    (ref: correlator.cpp:109-140): float32 [n/2] on the host."""
    dev = resolve_device(device)
    input_size = min(x1.size, x2.size)
    real_count = input_size // 2 * 2
    a, b = (torch.from_numpy(np.ascontiguousarray(x[:real_count])).to(dev)
            for x in (x1, x2))
    return correlate_device(a, b, input_size).cpu().numpy()


def main(argv=None) -> int:
    from srtb_tpu_torch.tools.main import _pop_device
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_device(argv)
    in_file_1 = argv[0] if len(argv) > 0 else "pol_1.bin"
    in_file_2 = argv[1] if len(argv) > 1 else "pol_2.bin"
    out_file = argv[2] if len(argv) > 2 else "/dev/shm/corr.bin"
    log.info(f"[correlator] reading {os.path.abspath(in_file_1)}")
    log.info(f"[correlator] reading {os.path.abspath(in_file_2)}")
    x1 = np.fromfile(in_file_1, dtype=np.uint8)
    x2 = np.fromfile(in_file_2, dtype=np.uint8)
    out = correlate(x1, x2, device)
    out.astype("<f4").tofile(out_file)
    log.info(f"[correlator] wrote {out.size} samples to {out_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

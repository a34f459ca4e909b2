"""The port's hand-written Hopper kernels.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card (there is no fallback
between the two), and counts its launches in a ``launches`` attribute.
``KERNELS`` lists them with the TPU kernel each replaces.
"""

from __future__ import annotations

# the modules, not their functions of the same names, stay the package's
# ``fft_rows`` and ``dedisperse`` attributes
from srtb_tpu_torch.kernels import dedisperse as _dedisperse
from srtb_tpu_torch.kernels import fft_rows as _fft_rows
from srtb_tpu_torch.kernels.fft2 import fft2_pass1, fft2_pass2
from srtb_tpu_torch.kernels.fft2_front import (fft2_pass1_front,
                                                 fft2_pass2_spectrum)
from srtb_tpu_torch.kernels.rfi_chirp import rfi_s1_dedisperse
from srtb_tpu_torch.kernels.sk import sk_apply_timeseries, sk_stats
from srtb_tpu_torch.kernels.unpack import (unpack_subbyte_planes_window,
                                             unpack_subbyte_window)

# (name, wrapper, CUDA source, TPU kernel it replaces: the pallas_call line)
KERNELS = (
    ("unpack_subbyte_window", unpack_subbyte_window,
     "srtb_tpu_torch/csrc/unpack.cu", "srtb_tpu/ops/pallas_kernels.py:679"),
    ("rfi_s1_dedisperse", rfi_s1_dedisperse,
     "srtb_tpu_torch/csrc/rfi_chirp.cu",
     "srtb_tpu/ops/pallas_kernels.py:383"),
    ("sk_stats", sk_stats,
     "srtb_tpu_torch/csrc/sk.cu", "srtb_tpu/ops/pallas_kernels.py:546"),
    ("sk_apply_timeseries", sk_apply_timeseries,
     "srtb_tpu_torch/csrc/sk.cu", "srtb_tpu/ops/pallas_kernels.py:604"),
    ("unpack_subbyte_planes_window", unpack_subbyte_planes_window,
     "srtb_tpu_torch/csrc/unpack.cu", "srtb_tpu/ops/pallas_kernels.py:763"),
    ("fft_rows", _fft_rows.fft_rows,
     "srtb_tpu_torch/csrc/fft_rows.cu", "srtb_tpu/ops/pallas_fft.py:496"),
    ("fft_rows_stats", _fft_rows.fft_rows_stats,
     "srtb_tpu_torch/csrc/fft_rows_stats.cu",
     "srtb_tpu/ops/pallas_fft.py:546"),
    ("fft_rows_skzap", _fft_rows.fft_rows_skzap,
     "srtb_tpu_torch/csrc/fft_rows_skzap.cu",
     "srtb_tpu/ops/pallas_fft.py:278"),
    ("dedisperse", _dedisperse.dedisperse,
     "srtb_tpu_torch/csrc/dedisperse.cu", "srtb_tpu/ops/pallas_kernels.py:421"),
    ("fft2_pass1", fft2_pass1,
     "srtb_tpu_torch/csrc/fft2.cu", "srtb_tpu/ops/pallas_fft2.py:531"),
    ("fft2_pass2", fft2_pass2,
     "srtb_tpu_torch/csrc/fft_rows.cu", "srtb_tpu/ops/pallas_fft2.py:571"),
    ("fft2_pass1_front", fft2_pass1_front,
     "srtb_tpu_torch/csrc/fft2_front.cu", "srtb_tpu/ops/pallas_fft2.py:864"),
    ("fft2_pass2_spectrum", fft2_pass2_spectrum,
     "srtb_tpu_torch/csrc/fft2_spectrum.cu",
     "srtb_tpu/ops/pallas_fft2.py:1046"),
)


# The counts are plain integers without a lock: kernels launch only on the
# thread that dispatches segments (the runtime's sink thread copies results
# and launches none), so no two increments race.
def reset_launch_counts() -> None:
    for _name, wrapper, _src, _tpu in KERNELS:
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper, _src, _tpu in KERNELS}

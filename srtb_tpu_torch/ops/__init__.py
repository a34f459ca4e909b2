"""The plain PyTorch ops, one for each device function of the JAX
package's ``ops``; the hand-written kernels that replace its Pallas
kernels live in :mod:`srtb_tpu_torch.kernels`."""

from srtb_tpu_torch.ops import (dedisperse, detect, fft, rfi,  # noqa: F401
                                spectrum, unpack, window)

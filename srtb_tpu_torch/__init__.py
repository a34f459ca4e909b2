"""srtb_tpu_torch — the PyTorch/CUDA port of the radio-telescope
transient-search backend, for one NVIDIA H100.

The same layers as the JAX package: ``config``, ``utils``, ``ops`` (the
plain PyTorch ops), ``kernels`` (the hand-written Hopper kernels and
their plain twins), ``pipeline``, ``io``, ``parallel``, ``gui``,
``quality``, ``resilience``, ``obs``, ``analysis`` and ``tools``.
Importing a package builds no kernel and touches no card: the kernel
library is built at its first launch.
"""

from srtb_tpu_torch.config import Config  # noqa: F401

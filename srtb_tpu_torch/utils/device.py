"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``"cuda"``).  A CUDA device that is not
    available raises: the CPU runs only when the caller asks for it
    (``device="cpu"``), as the tests and ``--device cpu`` do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --device "
            "cpu) to run the plain PyTorch versions on the CPU")
    return dev

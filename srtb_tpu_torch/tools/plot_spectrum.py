"""Offline spectrum plotting helper (port of
``srtb_tpu/tools/plot_spectrum.py``, ref: src/plot_spectrum.py;
``srtb-torch-plot-spectrum``).

Reads the ``<prefix><counter>.<i>.npy`` complex waterfalls the candidate
writer dumps and renders each as a dynamic-spectrum image next to it
(``<file>.png``): with matplotlib where it is importable, else with the
port's own colormap and PNG writer, the intensity normalized by twice its
mean and coloured on ``--device`` (the card by default).

Usage:
  python -m srtb_tpu_torch.tools.plot_spectrum [--device cpu] [GLOB ...]
"""

from __future__ import annotations

import glob
import sys

import numpy as np
import torch


def fallback_pixmap(power: np.ndarray, device=None) -> np.ndarray:
    """The reference's fallback image of a power array: the intensity
    ``power / (2 max(mean, 1e-30))`` in numpy as the reference forms it,
    coloured by :func:`~srtb_tpu_torch.ops.spectrum.generate_pixmap` on
    ``device``; ARGB32 uint32."""
    from srtb_tpu_torch.ops import spectrum as sp
    from srtb_tpu_torch.utils.device import resolve_device
    img = power / (2 * max(power.mean(), 1e-30))
    return sp.generate_pixmap(torch.from_numpy(
        img.astype(np.float32)).to(resolve_device(device)))


def plot_one(path: str, device=None) -> str:
    wf = np.load(path)
    power = np.abs(wf) ** 2
    out_path = path + ".png"
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        from srtb_tpu_torch.gui.waterfall import write_png
        write_png(out_path, fallback_pixmap(power, device))
        return out_path
    fig, ax = plt.subplots(figsize=(12, 7))
    ax.imshow(power, aspect="auto", origin="lower",
              interpolation="nearest")
    ax.set_xlabel("time sample")
    ax.set_ylabel("frequency channel")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("missing value for --device")
        device = argv[i + 1]
        del argv[i:i + 2]
    paths = []
    for pattern in (argv or ["*.npy"]):
        paths.extend(glob.glob(pattern))
    for p in sorted(paths):
        print(plot_one(p, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

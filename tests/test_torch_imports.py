"""The port stands alone: every module of ``srtb_tpu_torch`` imports
without JAX and without the JAX package, and so does ``chip_smoke.py``."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import srtb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(srtb_tpu_torch.__path__,
                                               "srtb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "srtb_tpu."))
             or m == "srtb_tpu")
print(len(names), bad)
"""


def test_every_port_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


def test_chip_smoke_names_neither_jax_nor_the_jax_package():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"\bjax\b", text)
    assert not re.search(r"\bsrtb_tpu\b(?!_torch)", text)


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the script fails and prints no result line."""
    import torch
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

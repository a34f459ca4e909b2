"""The port stands alone: every module of ``srtb_tpu_torch`` imports
without JAX and without the JAX package, and so does ``chip_smoke.py``;
its C++ and CUDA sources include nothing of the JAX package, and its
builds compile only sources of its own."""

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
    assert int(count) >= 30
    assert bad == "[]"


_PACKAGES_PROBE = """
import importlib, sys
from srtb_tpu_torch.kernels import build
def refuse(*_a, **_k):
    raise AssertionError("a package import built or loaded a library")
for name in ("build", "build_library", "build_host_library",
             "load_library", "library"):
    setattr(build, name, refuse)
import torch
for pkg in ("", ".analysis", ".gui", ".io", ".kernels", ".obs", ".ops",
            ".parallel", ".pipeline", ".quality", ".resilience", ".tools",
            ".utils"):
    importlib.import_module("srtb_tpu_torch" + pkg)
print(torch.cuda.is_initialized(), build._library is None,
      "triton" in sys.modules)
"""


def test_importing_the_packages_builds_nothing():
    """The packages' ``__init__`` imports (``ops``, ``pipeline``, ...)
    build and load no kernel library, import no ``triton`` and leave
    CUDA uninitialized: kernels are built at their first launch."""
    proc = subprocess.run([sys.executable, "-c", _PACKAGES_PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True", "False"]


def test_runtime_modules_are_the_ports_own():
    """The engine's modules (framework, buffer pool, termination, writer
    pool) exist in the port and are the ones the runtime uses."""
    from srtb_tpu_torch.io import native_writer
    from srtb_tpu_torch.pipeline import framework, runtime
    from srtb_tpu_torch.utils import bufferpool, termination
    for mod in (native_writer, framework, runtime, bufferpool, termination):
        assert mod.__name__.startswith("srtb_tpu_torch.")
    assert runtime.fw is framework and runtime.termination is termination
    assert runtime.AsyncWriterPool is native_writer.AsyncWriterPool


def test_native_sources_include_nothing_of_the_jax_package():
    """No C++ or CUDA source under ``srtb_tpu_torch/`` includes a file of
    ``srtb_tpu/``, and the builds read sources under the port only."""
    from srtb_tpu_torch.kernels import build
    port = REPO / "srtb_tpu_torch"
    sources = [p for ext in ("*.cpp", "*.cu", "*.cuh", "*.h")
               for p in port.rglob(ext)]
    assert any(p.suffix == ".cpp" for p in sources)
    for path in sources:
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not re.search(r"srtb_tpu\b(?!_torch)", line), \
                    f"{path.name}: {line}"
    for d in (build.CSRC_DIR, build.NATIVE_DIR):
        assert d.resolve().is_relative_to(port.resolve())


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

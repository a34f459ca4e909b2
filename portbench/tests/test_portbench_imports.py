"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``srtb_tpu`` (the part before the first dot
compared whole, so the port ``srtb_tpu_torch`` does not match), and a
reference that imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "srtb_tpu_torch_lookalike", sys)
    assert "srtb_tpu_torch_lookalike" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_submodule", sys)
    assert "jaxlib.fake_submodule" in forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """A whole cell at a small size on the CPU, in a fresh interpreter."""
    code = (
        "import json, sys, torch\n"
        "from portbench import run\n"
        "run.set_environment()\n"
        "ov = {'baseband_input_count': '2 ** 16',"
        " 'spectrum_channel_count': '2 ** 5', 'log_level': 1}\n"
        "run.run_cell('j1644.replay', 3, 0.5, False, torch.device('cpu'),"
        " overrides=ov)\n"
        "run.run_cell('j1644_dm8.replay', 3, 0.5, False,"
        " torch.device('cpu'), overrides=ov)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "srtb_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "portbench" / "reference"
    for path in ref.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("srtb_tpu_torch",) + FORBIDDEN, \
                    f"{path.name} imports {n}"
    code = ("import sys\nimport portbench.reference.chain\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "srtb_tpu_torch" not in out.stdout

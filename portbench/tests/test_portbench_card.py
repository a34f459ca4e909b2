"""On the card: every cell at its own size for a few seconds, correct.

Marked ``cuda``; without a card each test skips (decided in the fixture,
not when the module is imported).  Run on the card with
``python -m pytest portbench/tests -m cuda``.
"""

from __future__ import annotations

import pytest

from portbench import manifest as M
from portbench import run

CELLS = [w["name"] for w in M.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    run.set_environment()
    r = run.run_cell(cell, 2147483659, 3.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["attempted"] > 0

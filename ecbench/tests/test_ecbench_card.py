"""On the card at each cell's own size: the program's runs come out
correct and the control's do not, three seeds each, all read in one
process. Run on a machine with a card:
`python -m pytest ecbench/tests/test_ecbench_card.py -s`."""

import pytest

from ecbench import harness as H

SEEDS = [2**31 + 11, 3 * 2**30 + 7, 2**32 + 101]
CELLS = [w["name"] for w in H.manifest()["workloads"]]


def _run(cell, seed, device, adjust=None):
    out = H.run_cell(cell, seed, 2.0, False, device, adjust=adjust)
    print(cell, seed, "control" if adjust else "program",
          {n: c["value"] for n, c in out["checks"].items()})
    return out


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_at_the_cells_size(cell, card):
    for seed in SEEDS:
        assert _run(cell, seed, card)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, card):
    for seed in SEEDS:
        out = _run(cell, seed, card, adjust=lambda op: op.use_control())
        assert not out["correct"]

"""On the card: every cell runs end to end at its own size, short, and comes
out correct with its end-to-end metrics; its control comes out not correct.
Run on the chip with ``python3 -m pytest perfbench/tests -m cuda``."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import check, run  # noqa: E402

sys.path.remove(str(ROOT))

CELLS = [w["name"] for w in run.load_manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, cuda_device):
    cell = run.Cell(run.load_manifest(ROOT), name)
    result, _ = run.run_cell(cell, 2 ** 31 + 99, 1.0, False, cuda_device, time.monotonic())
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name, cuda_device):
    cell = run.Cell(run.load_manifest(ROOT), name)
    route = cell.route.Route(cell.config, cuda_device)
    seeds = range(2 ** 31 + 7, 2 ** 31 + 7 + int(cell.traffic["check_pricings"]))
    correct, numbers = check.judge([route.judge(s, route.control(s)) for s in seeds],
                                   cell.limits)
    assert not correct, numbers

"""On the card: the control (the program's S2DNet forward in TF32) and
the points-only BA fault come out not correct, and a sound run correct, at
the BA cell's own size, on one seed (``readings.py`` reads three or more
for ``PERF.md``):

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest
import torch

from portbench import readings

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 and the cell's size exist "
                    "only on the card")
    return "cuda"


def test_control_and_points_only_fault_on_the_card(card):
    rows = readings.readings("default_large.ba", [3000000077],
                             ["none", "control", "ba_points_only"],
                             device=card)
    got = {r["plant"]: r["correct"] for r in rows}
    assert got == {"none": True, "control": False,
                   "ba_points_only": False}, rows

"""Runs driven on the CPU through the harness, with the card check
skipped, at tiny sizes (``tiny.py``): a sound run of each entry comes out
correct, and every planted fault of ``faults.py`` that the entry can have
comes out not correct. The control (TF32) changes nothing that a CPU run
can show, since TF32 does not exist there; it is read on the card, at the
cell's own size, by ``test_portbench_control.py`` and ``readings.py``."""

import pytest

from portbench import faults
from portbench.tests import tiny

ENTRY_CELL = {"run_ba": "tiny_plane.ba"}
CASES = [(e, f) for e, fs in faults.FAULTS.items() for f in fs]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("entry", sorted(ENTRY_CELL))
def test_a_sound_run_is_correct(root, entry):
    r = tiny.run(root, ENTRY_CELL[entry])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("entry,fault", CASES)
def test_a_planted_fault_is_not_correct(root, entry, fault):
    r = tiny.run(root, ENTRY_CELL[entry], plant=fault)
    assert not r["correct"], (fault, r["checks"])


def test_every_entry_lists_its_faults():
    assert set(faults.FAULTS) == set(ENTRY_CELL)
    for fs in faults.FAULTS.values():
        assert set(fs) <= set(faults.HOOKS)

"""The control and each fault the cell can have make ``correct`` false;
the program as it is makes it true. At a few hosts on the CPU; on the card
at the cell's own size, ``python3 fleetbench/control.py``."""

import pytest

from conftest import small_cell

from fleetbench import control


@pytest.mark.parametrize("name", ("program",) + control.VARIANTS)
def test_variant(cpu_program, name):
    (row,) = control.run_variants(small_cell(), [2**32 + 9], 0.2, [name])
    assert row["attempted"] >= 1
    if name == "program":
        assert row["correct"] and row["failed"] == 0
    else:
        assert not row["correct"] and row["failed"] == row["attempted"]
        assert row["checks"]["wrong_links"] > 0

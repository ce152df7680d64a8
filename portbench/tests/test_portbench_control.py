"""The control (the reference with int4-grid weights in the program's
place) comes out not correct through the run's own comparison, at a
size a CPU test can hold; on the card ``portbench/control.py`` reads it
at the cells' own sizes."""

import pytest

from portbench.control import control_numbers


@pytest.mark.parametrize("cell, pool", [("sr_tiny.stream_tiny", 4),
                                        ("mnv2_tiny.stream_tiny", 2)])
def test_control_fails_the_comparison(tiny_root, cell, pool):
    row = control_numbers(tiny_root, cell, 2**31 + 5, "cpu", limit_pool=pool)
    assert row["compared"] == pool
    assert row["correct"] is False
    checks = row["checks"]
    assert checks["wrong_answers"]["value"] > checks["wrong_answers"]["limit"]
    assert checks["max_abs_diff"]["value"] > checks["max_abs_diff"]["limit"]

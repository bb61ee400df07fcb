"""The reference agrees with the port's CPU path at a small size: to the
last place with the port in float32, within the cell's limits with the
port in bfloat16 (its serving precision)."""

import pytest
import torch

from portbench import harness
from portbench.tests.small import SMALL, run_small, small_cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_float32_port_matches_the_reference(name):
    torch.set_num_threads(4)
    cell = small_cell(name, dtype="float32")
    # float32 against float32: only a rounding to the byte may differ
    cell.limits = {"limits": {"max_lsb": 1.0}}
    r = harness.execute(cell, 2**31 + 17, 1.5, False, device="cpu")
    assert r["failed"] == 0 and r["checks"]["max_lsb"]["value"] <= 1.0
    assert r["correct"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_bfloat16_port_passes_the_limits(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0

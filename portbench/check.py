"""The comparison that decides ``correct``.

Once the window has closed, the peak read and the program freed, the
plain float32 reference runs over the same frames from the first
dispatch, through the recurrence, and gives its outputs at the
dispatches the run kept. Each kept output is compared stream by stream
with the reference's, in units of the last place of the uint8 output
(LSB), and each is the worst over the compared (dispatch, stream) pairs:
``max_lsb`` the largest |program - reference| of a value, ``off4_pct``
the share of values (%) off by more than 4 LSB, ``mean_lsb`` the mean
|program - reference|. A cell compares the numbers its
``limits/<workload>.json`` names, with the readings they were set from;
all three are printed. The configuration file names the reference
module (``"reference"``: ``portbench/<name>.py``, whose ``run`` gives the
outputs at the kept dispatches), so a path the existing one does not serve
brings its own reference as a file of its own.
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, Tuple

import numpy as np


NUMBERS = ("mean_lsb", "max_lsb", "off4_pct")


def compare(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """The numbers of one (h, w, C) uint8 output against the
    reference's."""
    if prog.shape != ref.shape:
        return dict.fromkeys(NUMBERS, float("inf"))
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {"mean_lsb": float(d.mean()), "max_lsb": float(d.max()),
            "off4_pct": 100.0 * float((d > 4).mean())}


def check(cell, obs, device, quant=None) -> Tuple[Dict[str, dict], int]:
    """({number: {"value", "limit"}}, failed pairs). ``quant`` runs the
    reference in the program's place instead of reading the run's
    outputs (the control)."""
    reference = importlib.import_module(
        f"portbench.{cell.config['reference']}")
    ref = reference.run(cell.config, cell.traffic, obs.variables, obs.pool,
                        obs.samples, device)
    if quant is not None:
        prog = reference.run(cell.config, cell.traffic, obs.variables,
                             obs.pool, obs.samples, device, quant=quant)
    else:
        prog = obs.samples
    limits = cell.limits["limits"]
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = pairs = 0
    for i in sorted(ref):
        for s in range(ref[i].shape[0]):
            nums = compare(prog[i][s], ref[i][s])
            pairs += 1
            worst = {k: max(worst[k], nums[k]) for k in worst}
            failed += any(nums[k] > limits[k] for k in limits)
    print(f"compared {pairs} outputs ({len(ref)} dispatches) with the "
          f"reference: worst mean {worst['mean_lsb']!r} LSB, max "
          f"{worst['max_lsb']!r} LSB, off by more than 4 "
          f"{worst['off4_pct']!r}%", file=sys.stderr)
    return ({k: {"value": worst[k], "limit": limits[k]} for k in limits},
            failed)

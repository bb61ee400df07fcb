"""The output check's readings: the control, the reference put in the
program's place and computed one precision below the configuration's
(bfloat16 -> float8 e4m3 at every convolution's inputs and weights),
compared with the float32 reference at the cell's own size, as a run
compares; with ``--program S`` a run of the program (an S-second window)
on the same seed before it.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--dispatches N] [--program 3]

For each seed: the cell's seeded frames and weights, the dispatches a run
of ``N`` timed dispatches keeps (drawn from the seed as a run draws them,
after the warm-up, with the last), then each number against the cell's
limit, one JSON line each. The limits in ``limits/`` were set from such
readings on the card: above the largest the program gives, below the
smallest the control gives. The benchmark's runs do not run this;
``tests/test_portbench_control.py`` runs the control at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def control(cell, seed: int, dispatches: int, device) -> dict:
    """The numbers of one seed's control against the cell's limits:
    {"correct": bool, "checks": {...}}."""
    from portbench import check, reference
    from portbench.drivers.common import inputs
    from portbench.harness import Observation, Sampler

    pool, variables = inputs(cell, seed, device)
    warm = int(cell.traffic["warmup_dispatches"])
    if cell.traffic["driver"] == "convert":
        warm *= int(cell.config["pipeline"]["chunk_size"])
    sampler = Sampler(seed, int(cell.traffic["check_every"]))
    kept = [warm + j for j in range(dispatches) if sampler.keep(j)]
    kept.append(warm + dispatches - 1)
    obs = Observation(frames=0, attempted=0, window_s=0.0, setup_s=0.0,
                      samples=dict.fromkeys(kept), pool=pool,
                      variables=variables)
    checks, failed = check.check(cell, obs, device,
                                 quant=reference.fp8_e4m3)
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in checks.values())
    return {"correct": ok, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dispatches", type=int, default=1000,
                    help="timed dispatches of the run it stands for")
    ap.add_argument("--program", type=float, default=0.0,
                    help="seconds of a run of the program before each "
                    "control (0: none)")
    args = ap.parse_args(argv)
    from portbench.harness import execute, find_cell

    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program > 0:
            res = execute(cell, seed, args.program, False)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": "program", "correct": res["correct"],
                              "checks": res["checks"]}), flush=True)
        res = control(cell, seed, args.dispatches, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": "fp8", **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

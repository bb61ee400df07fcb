"""Run one cell of BENCHMARK.json once on the CUDA card(s) of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each number the output check compared, beside its limit, as the last
lines of standard error. Exits 2, printing no result, without the card(s)
the cell needs. Builds and caches stay in fixed directories inside the
checkout (``vidmat_torch/build/``, ``.portbench/cache/``: the kernels,
the extension and Triton caches, Python's compiled bytecode).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench", "cache")
# Compiled bytecode of every module imported from here on (PyTorch's
# included) is written to and read from a fixed directory of the checkout,
# also where the environment turns writing it off: only a checkout's first
# run compiles it (PyTorch's modules alone take seconds to compile).
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.t_start = T_START
    return args


if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(parse()))

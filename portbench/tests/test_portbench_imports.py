"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole), and its yardstick imports nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.small import SMALL

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH_DIR)
               for f in fs if f.endswith(".py"))
#: the yardstick: imports nothing of the program
YARDSTICK = ("yardstick.py", "reference.py", "check.py", "frames.py",
             "weights.py", "control.py", "harness.py")


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.BENCH_DIR)
                              for p in FILES])
def test_no_forbidden_import(path):
    tops = set(imported(path))
    assert not tops & set(harness.FORBIDDEN)
    if os.path.basename(path) in YARDSTICK and "tests" not in path:
        assert "vidmat_torch" not in tops


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_run_loads_no_jax(name):
    """A small cell on the CPU in a fresh interpreter, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.small import run_small\n"
        "from portbench.harness import loaded_forbidden\n"
        "r = run_small(%r, seconds=0.5)\n"
        "assert r['correct'], r\n"
        "print('FORBIDDEN', loaded_forbidden())\n" % (harness.ROOT, name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert "vidmat_torch" not in harness.FORBIDDEN
    assert [m for m in ("vidmat_torch.api", "vidmat_torchx", "jaxlib2")
            if m.split(".")[0] in harness.FORBIDDEN] == []

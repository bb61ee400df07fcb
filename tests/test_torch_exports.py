"""The port's subpackages export what the JAX package's subpackages export
(ROADMAP C.7): every name that ``vidmat/{models,utils,pipeline,io,ops,
refine,parallel,train}/__init__.py`` imports resolves in the matching
``vidmat_torch`` subpackage to the port's object of the same name in the
matching submodule, or raises NotImplementedError naming A.12 (what needs
more than one card). The exports are lazy: importing a subpackage loads
none of the submodules it names, except ``ops.guided_filter``, whose name
is the function in every import order, as in the JAX package."""

import ast
import importlib
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["models", "utils", "pipeline", "io", "ops", "refine",
               "parallel", "train"]
A12 = r"ROADMAP A\.12 \(more than one card\)"


def jax_exports(pkg):
    """{name: JAX module it comes from} of vidmat/<pkg>/__init__.py."""
    path = os.path.join(ROOT, "vidmat", pkg, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {a.asname or a.name: node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def resolve(pkg, name):
    """None where the port's name is the JAX package's object's
    counterpart, else what differs."""
    jax_obj = getattr(importlib.import_module(f"vidmat.{pkg}"), name)
    port_mod = jax_exports(pkg)[name].replace("vidmat.", "vidmat_torch.", 1)
    sub = importlib.import_module(f"vidmat_torch.{pkg}")
    try:
        got = getattr(sub, name)
    except NotImplementedError as e:
        if "ROADMAP A.12 (more than one card)" in str(e):
            return None
        return f"{name}: {e}"
    except AttributeError:
        return f"{name}: missing"
    if got.__name__ != jax_obj.__name__:
        return f"{name}: {got.__name__} != {jax_obj.__name__}"
    if got is not getattr(importlib.import_module(port_mod), name):
        return f"{name}: not {port_mod}.{name}"
    return None


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_subpackage_exports_resolve_or_name_their_item(pkg):
    names = jax_exports(pkg)
    assert names, pkg
    bad = [d for d in (resolve(pkg, n) for n in names) if d]
    assert not bad, bad
    with pytest.raises(AttributeError):
        getattr(importlib.import_module(f"vidmat_torch.{pkg}"),
                "no_such_name")


def test_all_34_names_resolve():
    """C.7's count: 34 names, of which 0 differ (29 before the repair);
    the three of the mesh and the pipeline split raise naming A.12."""
    names = [(p, n) for p in SUBPACKAGES for n in jax_exports(p)]
    assert len(names) == 34
    assert [f"{p}.{n}" for p, n in names if resolve(p, n)] == []
    import vidmat_torch.parallel as par

    for n in ("make_mesh", "PipelinedMatting", "PipelinedStreams"):
        with pytest.raises(NotImplementedError, match=A12):
            getattr(par, n)


def test_from_io_import_video_reader():
    from vidmat_torch.io import VideoReader
    from vidmat_torch.io.reader import VideoReader as direct

    assert VideoReader is direct


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          check=True, capture_output=True,
                          text=True).stdout.split()


@pytest.mark.parametrize("first", ["ops", "stepfactory"])
def test_ops_guided_filter_is_the_function_in_every_import_order(first):
    """In a fresh process, before and after the serving bodies import the
    submodule (or with them first), and through ``import ... as``, as
    ``vidmat.ops.guided_filter`` is."""
    code = (
        "import importlib\n"
        "order = ['{p}.ops', '{p}.pipeline.stepfactory']\n"
        "if {stepfactory_first}: order.reverse()\n"
        "for m in order:\n"
        "    importlib.import_module(m)\n"
        "    import {p}.ops as ops\n"
        "    print(type(ops.guided_filter).__name__)\n"
        "import {p}.ops.guided_filter as g\n"
        "print(type(g).__name__, g.__module__)\n")
    for p in ("vidmat", "vidmat_torch"):
        out = _fresh(code.format(p=p, stepfactory_first=first != "ops"))
        assert out == ["function", "function", "function",
                       f"{p}.ops.guided_filter"], (p, out)


def test_subpackage_imports_load_no_exported_submodule():
    """Importing the subpackages other than ``train`` (which imports its
    modules, as the JAX package's does) loads none of the submodules
    their exports name (``ops.guided_filter`` excepted), nor the bundles'
    module, the command line or the custom ops."""
    mods = sorted({m.replace("vidmat.", "vidmat_torch.", 1)
                   for p in SUBPACKAGES for m in jax_exports(p).values()}
                  - {"vidmat_torch.ops.guided_filter"})
    mods += ["vidmat_torch.deploy", "vidmat_torch.cli",
             "vidmat_torch.ops.library"]
    code = ("import sys\n"
            + "".join(f"import vidmat_torch.{p}\n" for p in SUBPACKAGES
                      if p != "train")
            + f"print(sorted(m for m in {mods!r} if m in sys.modules))")
    assert _fresh(code) == ["[]"]

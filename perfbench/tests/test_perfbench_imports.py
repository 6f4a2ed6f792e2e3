"""Nothing under perfbench/ imports jax or the JAX package (top-level
names compared whole, so srewd_tpu_torch is not srewd_tpu), and the
reference imports nothing of the program."""

import ast
import os

from perfbench import cell as cells

FORBIDDEN = {"jax", "jaxlib", "flax", "srewd_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_in_the_harness():
    bad = {(p, m) for p in _sources(cells.HERE) for m in _imports(p) if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(cells.HERE, "reference")
    bad = {(p, m) for p in _sources(ref) for m in _imports(p)
           if m in FORBIDDEN | {"srewd_tpu_torch", "perfbench"}}
    assert not bad


def test_the_guard_compares_whole_names():
    from perfbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "srewd_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
    assert "srewd_tpu" in RUN_FORBIDDEN and "jax" in RUN_FORBIDDEN

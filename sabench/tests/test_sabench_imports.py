"""What the benchmark imports, by top-level module name compared whole."""

import ast
import os

import pytest

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "stringsearch_tpu"}
# the yardstick: inputs, reference, peaks and metric arithmetic, which take
# nothing of the program
REFERENCE = ["reference.py", "peaks.py", "generators", "metrics", "layers"]


def python_files(*parts):
    for part in parts:
        path = os.path.join(BASE, part)
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, _, filenames in os.walk(path):
            for fn in filenames:
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(python_files(".")))
def test_nothing_imports_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted(python_files(*REFERENCE)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "stringsearch_torch" not in top_level_imports(path)


def test_the_name_is_compared_whole():
    # the port's name begins with the JAX package's, and is allowed
    assert "stringsearch_torch".split(".")[0] not in JAX
    assert top_level_imports(os.path.join(BASE, "program.py")) >= {
        "stringsearch_torch"}

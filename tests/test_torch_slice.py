"""The port's first slice end to end against the JAX package.

build -> verify -> LCS and exact queries, on the same enwik-like text,
through `stringsearch_torch` on the CPU and `stringsearch_tpu` on the CPU;
every answer is an integer and compared exactly. Also: the corpus
generators are byte-identical, and the port never imports jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stringsearch_tpu as jst
import stringsearch_torch as tst
from stringsearch_torch import oracle
from stringsearch_torch.harness import corpus as tcorpus
from stringsearch_tpu.harness import corpus as jcorpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _queries(text: np.ndarray, count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        m = int(rng.integers(2, 48))
        if i % 2 == 0:
            s = int(rng.integers(0, len(text) - m))
            out.append(text[s : s + m].tobytes())
        else:
            out.append(rng.integers(97, 123, m, dtype=np.uint8).tobytes())
    return out


def test_slice_end_to_end_matches_jax():
    data = tcorpus.enwik_like(1 << 16)
    text = np.frombuffer(data, dtype=np.uint8)
    sa = tst.build_suffix_array(data, device="cpu")
    assert sa.sa.device.type == "cpu" and sa.sa.dtype == torch.int32
    sa.verify()
    jsa = jst.build_suffix_array(data)
    np.testing.assert_array_equal(sa.sa.numpy(), np.asarray(jsa.sa))
    assert oracle.sufcheck(text, sa.sa.numpy()) == 0

    lcs_needles = _queries(text, 64, 1)
    got = sa.longest_substring_match_batch(lcs_needles)
    want = jsa.longest_substring_match_batch(lcs_needles)
    assert [(g.start, g.len) for g in got] == [(w.start, w.len) for w in want]
    assert all(g.as_bytes() == w.as_bytes() for g, w in zip(got, want))

    exact = _queries(text, 64, 2)
    assert [sa.search(nd) for nd in exact] == [jsa.search(nd) for nd in exact]


@pytest.mark.parametrize("n", [1000, 1 << 14, (1 << 17) + 3])
def test_enwik_like_is_byte_identical(n):
    assert tcorpus.enwik_like(n) == jcorpus.enwik_like(n)


def test_other_generators_are_byte_identical():
    assert tcorpus.regression_corpus() == jcorpus.regression_corpus()
    assert tcorpus.random_bytes(999, 7, 3) == jcorpus.random_bytes(999, 7, 3)
    assert tcorpus.shruggy() == jcorpus.shruggy()


def test_oracle_wrapper_matches_jax_oracle():
    from stringsearch_tpu import oracle as joracle

    data = tcorpus.enwik_like(5000, seed=11)
    sa = oracle.build(data)
    np.testing.assert_array_equal(sa, joracle.build(data))
    assert oracle.sufcheck(data, sa) == 0
    bad = sa.copy()
    bad[[10, 11]] = bad[[11, 10]]
    assert oracle.sufcheck(data, bad) == joracle.sufcheck(data, bad) != 0
    assert oracle.search(data, b"the", sa) == joracle.search(data, b"the", sa)
    assert oracle.simplesearch(data, 32, sa) == joracle.simplesearch(data, 32, sa)


def test_port_never_imports_jax():
    """Every module of the package, imported in a fresh interpreter, brings
    in neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stringsearch_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    stringsearch_torch.__path__, 'stringsearch_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for need in ('engines.dc3', 'engines.bstar', 'harness.cli',\n"
        "             'harness.fuzz', 'harness.microbench',\n"
        "             'harness.scaling', 'ops.radix', 'ops.radix_sort',\n"
        "             'ops.steps', 'ops.merge',\n"
        "             'parallel.partitioned', 'parallel.collectives',\n"
        "             'parallel.mesh', 'parallel.distsort',\n"
        "             'parallel.gather', 'parallel.global_sa',\n"
        "             'parallel.comm_model', 'parallel.multihost',\n"
        "             'transforms.bwt',\n"
        "             'utils.sizes'):\n"
        "    assert 'stringsearch_torch.' + need in names, need\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'stringsearch_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 36


def _port_sources() -> list:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "stringsearch_torch")):
        # build outputs and byte code are no sources: never descend into them
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cpp", ".h"))]
    return sorted(paths)


def test_port_sources_name_the_jax_package_in_no_import_or_path():
    """No file of the port imports jax or the JAX package, or builds a path
    into it. Docstrings and comments name their counterparts there, in
    prose: `stringsearch_tpu/...` after "Counterpart of" and the like."""
    import re

    imports = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|stringsearch_tpu)\b", re.M)
    # the package's name inside a string that code could use as a path or a
    # module name: a quoted literal that starts with it
    literal = re.compile(r"""["'](\.{0,2}/)?stringsearch_tpu[/."']""")
    sources = _port_sources()
    assert len(sources) >= 33
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        where = os.path.relpath(path, REPO)
        assert not imports.search(text), where
        if where == "chip_smoke.py":
            # its report names each TPU kernel it replaces, as file:line
            text = re.sub(r"stringsearch_tpu/ops/(bitonic|radix)\.py:", "",
                          text)
        assert not literal.search(text), where
        for call in ("importlib.import_module", "__import__"):
            for m in re.finditer(re.escape(call) + r"\(([^)]*)\)", text):
                assert "stringsearch_tpu" not in m.group(1) \
                    and "jax" not in m.group(1), where

"""The multi-device layer on the card: shards of one GPU against the CPU.

The exact global suffix array on P = 2, 4 and 8 shards of one CUDA device
(`make_mesh(devices=[cuda] * P)`), every local sort on the hand-written
radix sort: SA and ISA equal to the same build on `[cpu] * P` and to the
C++ oracle, the sharded verify, the compacted rounds and the merge-split
fallback, int64 indexes, and the queries in both text modes. Integers,
tolerance none. Marked `cuda`: they skip without a GPU. Run them on the
card with `python -m pytest --noconftest -m cuda
tests/test_torch_global_cuda.py` (this file does not import jax).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch import NotSorted, oracle
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import bitonic, radix_sort
from stringsearch_torch.parallel import distsort
from stringsearch_torch.parallel.global_sa import build_global
from stringsearch_torch.parallel.mesh import make_mesh

SHARDS = [2, 4, 8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _texts() -> dict:
    rng = np.random.default_rng(7)
    return {
        "enwik-2^16": enwik_like(1 << 16, seed=3),
        "alpha4-5000": rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(),
        "ab-4096": b"ab" * 2048,
        "odd-1003": rng.integers(0, 8, 1003, dtype=np.uint8).tobytes(),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", sorted(_texts()))
def test_global_build_on_the_card_equals_the_cpu(cuda, p, name):
    text = _texts()[name]
    radix_sort.launches = 0
    bitonic.launches = 0
    g = build_global(text, make_mesh(devices=[cuda] * p))
    launches = radix_sort.launches
    assert launches > 0 and bitonic.launches == 0
    assert all(t.device == cuda for t in g.rank + g._sa_sharded)
    want = build_global(text, make_mesh(devices=[torch.device("cpu")] * p))
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    np.testing.assert_array_equal(torch.cat(g.rank).cpu().numpy(),
                                  torch.cat(want.rank).numpy())
    assert (g.rounds_run, g.compact_rounds_run) == \
        (want.rounds_run, want.compact_rounds_run)
    g.verify()
    g.rank[0] = g.rank[0].clone()
    g.rank[0][1] = g.rank[0][2]
    with pytest.raises(NotSorted, match="permutation"):
        g.verify()


@pytest.mark.cuda
def test_global_fallbacks_and_int64_on_the_card(cuda):
    text = bytes([5]) * 3000
    distsort.fallbacks.clear()
    g = build_global(text, make_mesh(devices=[cuda] * 4), depth=4, fan=2)
    assert distsort.fallbacks["rank_interval"] > 0
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    text = enwik_like(20000, seed=9)
    g64 = build_global(text, make_mesh(devices=[cuda] * 4), idx=torch.int64)
    assert g64.suffix_array().dtype == np.int64
    np.testing.assert_array_equal(g64.suffix_array(), oracle.build(text))
    g64.verify()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_global_queries_on_the_card_equal_the_cpu(cuda, mode):
    text = enwik_like(1 << 16, seed=5)
    rng = np.random.default_rng(3)
    needles = [text[s:s + int(rng.integers(1, 40))]
               for s in rng.integers(0, len(text) - 40, 24)]
    needles += [b"zzqzzq", b"\x00", b"e"]
    g = build_global(text, make_mesh(devices=[cuda] * 4))
    h = build_global(text, make_mesh(devices=[torch.device("cpu")] * 4))
    assert [(m.start, m.len) for m in
            g.longest_substring_match_batch(needles, text_mode=mode)] == \
        [(m.start, m.len) for m in
         h.longest_substring_match_batch(needles, text_mode=mode)]
    assert g.sa_search_batch(needles, text_mode=mode) == \
        h.sa_search_batch(needles, text_mode=mode)
    osa = oracle.build(text)
    for c in (0, 32, 101):
        assert g.sa_simplesearch(c, mode) == \
            oracle.simplesearch(text, c, osa)

"""Port of engines/bstar.py against the JAX engine, a numpy model and the
C++ oracle.

Layered as the reference's tests/test_bstar.py: the classification against
the JAX function and a numpy model of the right-to-left scan; the B*
positions, their names, the reduced SA and ISA and the induced order
against the JAX functions on the same inputs; the full build's SA and ISA
against the JAX build, brute force and the oracle; the traces byte for
byte. All tolerance 0. The JAX side compiles once per shape, so the
generated cases share one length (n = 311, as in the reference's tests).

The reference pads the B* list to n//2 + 1 for jit; the port holds m
entries. So the port's B* positions, names and reduced SA are the
reference's first m entries (its reduced SA: the last m), and the port's
reduced ISA is the reference's less its cap - m pads.

The `cuda` tests run the kernel route and skip without a card:
`python -m pytest --noconftest -m cuda tests/test_torch_bstar.py`
(this file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch import oracle
from stringsearch_torch.engines import bstar, doubling
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.harness.tracing import Tracer
from stringsearch_torch.ops import bitonic

FIXED_N = 311  # one JAX compile for all random cases
# its B* windows are 203 bytes, more than the 16 + 16 + 32 + 64 bytes the
# first four sorts compare: only the unbounded stage tells them apart
EXT_TEXT = (b"a" * 200 + b"b") * 3


def _np_classify(t: np.ndarray):
    """The right-to-left classification scan in numpy."""
    n = len(t)
    tb = np.zeros(n, bool)
    for i in range(n - 2, -1, -1):
        tb[i] = t[i] < t[i + 1] or (t[i] == t[i + 1] and tb[i + 1])
    bs = np.zeros(n, bool)
    if n > 1:
        bs[:-1] = tb[:-1] & ~tb[1:]
    return tb, bs


def _rand_cases(seed=7, count=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        k = int(rng.integers(1, 6))
        out.append(rng.integers(0, 1 << (2 * k), FIXED_N)
                   .astype(np.uint8).tobytes())
    return out


SPECIALS = [
    b"aacb", b"abracadabra", b"mississippi", b"aaaaaaaa", b"abcabcabc",
    b"zyxwv", b"abababab", b"aabaabaab", b"\x00\x00\x01\x00",
    b"\xff\xfe\xff\xff\xff", bytes(range(250)) + bytes([0]),
    b"a" * 60 + b"b" + b"a" * 50 + b"b",
]


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _brute(data: bytes) -> list:
    return sorted(range(len(data)), key=lambda i: data[i:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _ids(cases) -> list:
    return [f"{i}:{len(c)}B" for i, c in enumerate(cases)]


@pytest.mark.parametrize("case", SPECIALS + _rand_cases(count=4),
                         ids=_ids(SPECIALS + _rand_cases(count=4)))
def test_classify_matches_jax_and_the_model(case):
    import jax.numpy as jnp

    from stringsearch_tpu.engines import bstar as jbstar

    t = _u8(case)
    seg_end, type_b, bs = bstar._classify(torch.from_numpy(t.copy()))
    jseg, jtb, jbs = jbstar._classify(jnp.asarray(t))
    np.testing.assert_array_equal(seg_end.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(type_b.numpy(), np.asarray(jtb))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    tb_ref, bs_ref = _np_classify(t)
    np.testing.assert_array_equal(type_b.numpy(), tb_ref)
    np.testing.assert_array_equal(bs.numpy(), bs_ref)
    assert seg_end.dtype == torch.int32
    i64 = bstar._classify(torch.from_numpy(t.copy()), torch.int64)[0]
    assert i64.dtype == torch.int64 and torch.equal(i64, seg_end.long())


@pytest.mark.parametrize("case", [b"mississippi"] + _rand_cases(seed=3,
                                                               count=1),
                         ids=["mississippi", "random"])
def test_names_and_reduced_problem_match_jax(case):
    """B* positions, window words, names, and the reduced SA and ISA; the
    sorted B* against brute force."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import bstar as jbstar

    t = _u8(case)
    tt = torch.from_numpy(t.copy())
    jt = jnp.asarray(t)
    n = len(t)
    _, _, bs = bstar._classify(tt)
    p = bstar._extract_bstar(bs)
    m = p.shape[0]
    jp, jm = jbstar._extract_bstar(jbstar._classify(jt)[2])
    assert int(jm) == m > 0
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp)[:m])
    assert (np.asarray(jp)[m:] == n).all()

    # the first window words of the first sort, unbiased
    nxt = torch.cat([p[1:], p.new_full((1,), n)])
    wlen = torch.where(nxt < n, nxt + 2 - p, n - p)
    words, lenk = bstar._window_words(bstar._pack_all4(tt), p, wlen, 4, 3, n)
    jwords, jlenk = jbstar._window_words(
        jbstar._pack_all4(jt), jp, jnp.asarray(np.concatenate(
            [wlen.numpy(), np.zeros(len(jp) - m, np.int32)])), 4, 3, n)
    for w, jw in zip(words, jwords):
        got = (w.numpy() ^ np.int32(np.iinfo(np.int32).min)).view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(jw)[:m])
    np.testing.assert_array_equal(lenk.numpy(), np.asarray(jlenk)[:m])

    red = bstar._name_and_rank(tt, p)
    jred = np.asarray(jbstar._name_and_rank(jt, jp, jm))
    cap = len(jred)
    np.testing.assert_array_equal(red.numpy(), jred[:m])
    np.testing.assert_array_equal(jred[m:], np.arange(m, cap) - cap)
    sa_red, isa_red = doubling.build_ints_with_isa(red, depth=6)
    jsa, jisa = jbstar._redsolve(jnp.asarray(jred), jnp.int32, 6,
                                 (4, 32, 256), 4)
    np.testing.assert_array_equal(sa_red.numpy(), np.asarray(jsa)[cap - m:])
    np.testing.assert_array_equal(isa_red.numpy() + (cap - m),
                                  np.asarray(jisa)[:m])
    pos = p.numpy()
    assert pos[sa_red.numpy()].tolist() == sorted(
        pos.tolist(), key=lambda i: case[i:])


def _phase_b_tables(t: torch.Tensor):
    """The B phase's inputs to `_induce`, as `build` makes them."""
    n = t.shape[0]
    j = torch.arange(n, dtype=torch.int32)
    seg_end, type_b, bs = bstar._classify(t)
    p = bstar._extract_bstar(bs)
    _, isa_red = doubling.build_ints_with_isa(bstar._name_and_rank(t, p),
                                              depth=6)
    bsr = torch.full((n,), -1, dtype=torch.int32)
    bsr[p] = isa_red
    prev = torch.cat([bsr.new_full((1,), -1), bsr[:-1]])
    char = t.to(torch.int32)

    def col(v, last):
        return torch.cat([v, v.new_full((1,), last)])

    return (type_b,
            col(torch.where(type_b, 2 * char + 1, 2 * char), 2**31 - 1),
            col(torch.where(type_b, -(seg_end - j + 1), prev), 0),
            col(torch.where(type_b, seg_end + 1, j), n))


@pytest.mark.parametrize("hops", [1, 4])
def test_induce_matches_jax(hops):
    """The induced order of the type-B suffixes: their sorted positions and
    head-slot ranks, with few hops (refinement rounds) and the default."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import bstar as jbstar

    t = torch.from_numpy(_u8(_rand_cases(seed=11, count=1)[0]).copy())
    tables = _phase_b_tables(t)
    pos_s, rank_pos, nsel = bstar._induce(*tables, hops)
    jpos, jrank, jnsel = jbstar._induce(
        *(jnp.asarray(x.numpy()) for x in tables), hops, jnp.int32)
    assert nsel == int(jnsel) > 0
    np.testing.assert_array_equal(pos_s.numpy()[:nsel],
                                  np.asarray(jpos)[:nsel])
    sel = tables[0].numpy()
    np.testing.assert_array_equal(rank_pos.numpy()[sel],
                                  np.asarray(jrank)[sel])


@pytest.mark.parametrize("case", _rand_cases(count=12),
                         ids=_ids(_rand_cases(count=12)))
def test_full_build_matches_jax(case):
    """SA and ISA of the fused build, one JAX compile for all cases."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import bstar as jbstar

    sa, isa = bstar.build(_u8(case), device="cpu")
    jsa, jisa = jbstar.build(jnp.asarray(_u8(case)))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(isa.numpy(), np.asarray(jisa))
    assert sa.tolist() == _brute(case)


@pytest.mark.parametrize("case", SPECIALS, ids=_ids(SPECIALS))
def test_full_build_brute_force(case):
    sa = bstar.sort(case, device="cpu")
    assert sa.sa.tolist() == _brute(case)
    assert sa.sa.dtype == torch.int32


def test_short_inputs_delegate():
    for case in (b"", b"a", b"ab", b"ba", b"aa"):
        assert bstar.sort(case, device="cpu").sa.tolist() == _brute(case)
    with pytest.raises(ValueError):
        bstar.build(b"ab", device="cpu")
    out = np.zeros(6, dtype=np.int32)
    bstar.sort_in_place(b"banana", out, device="cpu")
    assert out.tolist() == [5, 3, 1, 0, 4, 2]


def test_oracle_conformance_enwik():
    data = enwik_like(1 << 13)
    sa = bstar.sort(data, device="cpu")
    sa.verify()
    np.testing.assert_array_equal(sa.sa.numpy(), oracle.build(data))


class PlaneLog:
    """`device_sort` that keeps the plane count of every call."""

    def __init__(self):
        self.planes = []

    def __call__(self, operands, num_keys=1):
        operands = tuple(operands)
        self.planes.append(len(operands))
        return bitonic.device_sort(operands, num_keys)


def test_unbounded_extension_stage_runs(monkeypatch):
    """The four extension stages sort 7, 11, 19 and 35 planes; this input
    needs them all."""
    log = PlaneLog()
    monkeypatch.setattr(bstar, "device_sort", log)
    sa = bstar.sort(EXT_TEXT, device="cpu")
    np.testing.assert_array_equal(sa.sa.numpy(), oracle.build(EXT_TEXT))
    assert [c for c in log.planes if c in (7, 11, 19, 35)] == [7, 11, 19, 35]


def _traces_equal(data: bytes, tmp_path) -> str:
    from stringsearch_tpu.engines import bstar as jbstar
    from stringsearch_tpu.harness import tracing as jtracing

    with Tracer(str(tmp_path / "torch")) as tr:
        sa = bstar.sort_traced(data, tr, device="cpu")
    with jtracing.Tracer(str(tmp_path / "jax")) as jtr:
        jbstar.sort_traced(data, jtr)
    got = (tmp_path / "torch").read_text()
    assert got == (tmp_path / "jax").read_text()
    assert sa.sa.tolist() == _brute(data)
    return got


@pytest.mark.parametrize("name", ["random", "extension", "constant", "ab"])
def test_sort_traced_equals_jax(name, tmp_path):
    data = {"random": _rand_cases(seed=5, count=1)[0],
            "extension": EXT_TEXT,
            "constant": b"q" * FIXED_N,  # no B* at all
            "ab": b"ab"}[name]
    got = _traces_equal(data, tmp_path)
    assert got.startswith(f":: bstar engine n={len(data)}\n")
    if name == "constant":
        assert f"B*=0 of {FIXED_N}" in got
    elif name != "ab":
        assert ":: sorted B* suffixes len=" in got


@pytest.mark.cuda
def test_bstar_on_the_card(cuda):
    from stringsearch_torch.ops import radix_sort

    cases = SPECIALS + _rand_cases(count=12) + [EXT_TEXT, enwik_like(1 << 17)]
    for case in cases:
        before = radix_sort.launches
        sa, isa = bstar.build(case, device=cuda)
        want_sa, want_isa = bstar.build(case, device="cpu")
        assert sa.device.type == "cuda" and radix_sort.launches > before
        assert torch.equal(sa.cpu(), want_sa) and torch.equal(isa.cpu(),
                                                              want_isa)
        np.testing.assert_array_equal(sa.cpu().numpy(), oracle.build(case))


@pytest.mark.cuda
def test_bstar_trace_on_the_card_equals_the_cpu_trace(cuda, tmp_path):
    for i, data in enumerate((EXT_TEXT, _rand_cases(seed=5, count=1)[0])):
        with Tracer(str(tmp_path / f"gpu{i}")) as tr:
            bstar.sort_traced(data, tr, device=cuda)
        with Tracer(str(tmp_path / f"cpu{i}")) as tr:
            bstar.sort_traced(data, tr, device="cpu")
        assert (tmp_path / f"gpu{i}").read_bytes() == \
            (tmp_path / f"cpu{i}").read_bytes()

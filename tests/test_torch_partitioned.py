"""Port of parallel/partitioned.py against the JAX package.

The same bytes go through `stringsearch_torch.PartitionedSuffixArray` on
the CPU and `stringsearch_tpu.PartitionedSuffixArray`; suffix arrays,
starts, lengths, counts and positions are integers and compared exactly
(tolerance 0). The batched build (all partitions in the same sorts) is also
held against the flat build of each chunk and against the host loop over
the oracle. Counterparts of the ten tests of tests/test_partitioned.py are
among them. The `cuda`-marked twins run on the card; run them with
`python -m pytest --noconftest -m cuda tests/test_torch_partitioned.py`
(this file imports jax only inside the tests that compare with it).
"""

import os

import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch.engines import doubling
from stringsearch_torch.ops import bitonic, radix_sort
from stringsearch_torch.parallel import partitioned

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
PARTS = [1, 2, 3, 4, 7]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _jax():
    import stringsearch_tpu as jst

    return jst


def _texts() -> dict:
    rng = np.random.default_rng(17)
    return {
        "empty": b"",
        "five": b"abcab",  # n < P for P = 7: partitions of one byte
        "two-zeros": b"\x00\x00",
        "alpha4-600": rng.integers(0, 4, 600, dtype=np.uint8).tobytes(),
        "alpha4-601": rng.integers(0, 4, 601, dtype=np.uint8).tobytes(),
        "random-420": rng.integers(0, 256, 420, dtype=np.uint8).tobytes(),
        "zeros-101": bytes(101),
        # full rounds all the way to h == L
        "ab-8192": b"ab" * (1 << 12),
        # both reach compaction inside a batched build: a period-2 stretch,
        # and a 0xFF run that lies in three partitions of three
        "ab-stretch": (rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
                       + b"ab" * 1024
                       + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()),
        "ff-run-3-parts": (rng.integers(0, 256, 1900, dtype=np.uint8).tobytes()
                           + b"\xff" * 2200
                           + rng.integers(0, 256, 1900, dtype=np.uint8).tobytes()),
    }


TEXTS = _texts()


def _brute_in_partition(text: bytes, nd: bytes, psize: int) -> list:
    out = []
    s = text.find(nd)
    while s != -1:
        if s // psize == (s + len(nd) - 1) // psize:
            out.append(s)
        s = text.find(nd, s + 1)
    return out


def _check_sas(text: bytes, parts: int, device) -> st.PartitionedSuffixArray:
    """The batched build against the flat build of each chunk and against
    the host loop over the oracle (which shares the pad-slot overwrite)."""
    p = st.PartitionedSuffixArray(text, parts, device=device)
    assert p.sas.dtype == torch.int32
    assert p.sas.shape == (parts, p.partition_size) == p.chunks.shape
    want = st.PartitionedSuffixArray(text, parts, engine="oracle",
                                     device=device)
    assert torch.equal(p.sas, want.sas)
    assert torch.equal(p.real_lens, want.real_lens)
    # before the overwrite: each partition is the flat build of its chunk
    _, raw = partitioned.build_partitioned(p.chunks.reshape(-1), parts)
    for i in range(parts):
        flat = st.build_suffix_array(p.chunks[i]).sa
        assert torch.equal(raw[i], flat), (parts, i)
    return p


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_build_partitioned_matches_jax_and_per_chunk_builds(name, parts):
    text = TEXTS[name]
    p = _check_sas(text, parts, "cpu")
    jp = _jax().PartitionedSuffixArray(text, parts)
    assert p.partition_size == jp.partition_size
    np.testing.assert_array_equal(p.sas.numpy(), np.asarray(jp.sas))
    np.testing.assert_array_equal(p.chunks.numpy(), np.asarray(jp.chunks))
    np.testing.assert_array_equal(p.real_lens.numpy(),
                                  np.asarray(jp.real_lens))


def test_batched_build_is_one_build(monkeypatch):
    """The sorts of a batched build do not grow with P, and both
    compaction inputs do reach the compaction rounds inside it."""
    compact_rounds = []
    real = doubling._compact_round

    def counted(*args, **kwargs):
        compact_rounds.append(1)
        return real(*args, **kwargs)

    sorts = []

    def recorded(operands, num_keys=1):
        sorts.append((len(operands), num_keys))
        return bitonic.plain_sort(operands, num_keys)

    monkeypatch.setattr(doubling, "_compact_round", counted)
    monkeypatch.setattr(doubling, "device_sort", recorded)
    for name in ("ab-stretch", "ff-run-3-parts"):
        per_parts = {}
        for parts in (1, 3, 4):
            sorts.clear()
            compact_rounds.clear()
            st.PartitionedSuffixArray(TEXTS[name], parts, device="cpu")
            assert compact_rounds, (name, parts)
            per_parts[parts] = len(sorts)
            # the initial sort: three packed keys and the position, led
            # by the partition index where there is more than one
            assert sorts[0] == ((4, 3) if parts == 1 else (5, 4))
            assert max(c for c, _ in sorts) <= bitonic._MAX_PLANES
        # a round more or less as the chunks get shorter, never a factor P
        assert max(per_parts.values()) <= per_parts[1] + 4, per_parts


def test_build_sa_chunk_argument():
    text = torch.from_numpy(
        np.frombuffer(TEXTS["alpha4-600"], dtype=np.uint8).copy())
    flat = doubling.build_sa(text, depth=12)
    assert torch.equal(doubling.build_sa(text, depth=12, chunk=600), flat)
    sa, isa = doubling.build_with_isa(text, depth=12, chunk=150)
    for i in range(4):
        chunk_sa = doubling.build_sa(text[150 * i : 150 * (i + 1)], depth=12)
        assert torch.equal(sa[150 * i : 150 * (i + 1)] - 150 * i, chunk_sa)
    assert torch.equal(isa[sa.to(torch.int64)],
                       torch.arange(600, dtype=torch.int32))
    with pytest.raises(ValueError):
        doubling.build_sa(text, depth=12, chunk=7)


def _needle_arrays(needles):
    from stringsearch_torch.core.search import _needle_batch_to_windows

    padded, lens, _w = _needle_batch_to_windows(needles)
    return padded, lens


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_query_and_search_functions_match_jax(parts):
    """`partitioned_query` and `partitioned_search` against the JAX
    functions on the same arrays."""
    import jax.numpy as jnp

    from stringsearch_tpu.parallel import partitioned as jpart

    text = TEXTS["alpha4-601"]
    rng = np.random.default_rng(parts)
    needles = [text[s : s + k] for s, k in
               zip(rng.integers(0, 590, 12).tolist(),
                   rng.integers(1, 11, 12).tolist())]
    needles += [b"\x00", b"\x03\x03", b"\x07\x07", b"\x01" * 20]
    p = st.PartitionedSuffixArray(text, parts, device="cpu")
    jp = _jax().PartitionedSuffixArray(text, parts)
    padded, lens = _needle_arrays(needles)
    steps = p._steps()
    start, length = partitioned.partitioned_query(
        p.chunks, p.sas, p.text, p.real_lens, torch.from_numpy(padded),
        torch.from_numpy(lens), steps)
    jstart, jlength = jpart.partitioned_query(
        jp.chunks, jp.sas, jp.text, jp.real_lens, jnp.asarray(padded),
        jnp.asarray(lens), steps)
    np.testing.assert_array_equal(length.numpy(), np.asarray(jlength))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    count, first = partitioned.partitioned_search(
        p.chunks, p.sas, p.real_lens, torch.from_numpy(padded),
        torch.from_numpy(lens), steps)
    jcount, jfirst = jpart.partitioned_search(
        jp.chunks, jp.sas, jp.real_lens, jnp.asarray(padded),
        jnp.asarray(lens), steps)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    assert count.dtype == first.dtype == start.dtype == torch.int32


def test_tie_between_partitions_goes_to_the_earliest():
    """Two partitions hold the same best match: the earlier one answers,
    as the reference's `argmax` does, and not by the device's leave."""
    text = b"xxabcdyy" + b"zzabcdww" + b"abcdabcd"
    for parts in (3, 6):
        p = st.PartitionedSuffixArray(text, parts, device="cpu")
        jp = _jax().PartitionedSuffixArray(text, parts)
        for nd in (b"abcd", b"abcdq", b"cd", b"w"):
            m = p.longest_substring_match(nd)
            jm = jp.longest_substring_match(nd)
            assert (m.start, m.len) == (jm.start, jm.len), (parts, nd)
        assert p.longest_substring_match(b"abcd").start == 2


def test_frequent_byte_needle_without_the_mask(monkeypatch):
    """A needle with n/20 occurrences among others: counts and first
    positions against the text, with the ranges expanded in several
    blocks."""
    rng = np.random.default_rng(5)
    arr = rng.integers(97, 117, 40000, dtype=np.uint8)  # 20 letters
    text = arr.tobytes()
    needles = [b"e", b"ee", b"a", b"zz", text[100:104], b"t"] * 3
    monkeypatch.setattr(partitioned, "_RANGE_BLOCK", 1000)
    for parts in (1, 3, 4):
        p = st.PartitionedSuffixArray(text, parts, device="cpu")
        got = p.sa_search_batch(needles)
        for nd, (count, first) in zip(needles, got):
            want = _brute_in_partition(text, nd, p.partition_size)
            assert count == len(want), (parts, nd)
            assert first == (min(want) if want else -1), (parts, nd)
        assert got[0][0] == text.count(b"e") > 40000 // 25
        assert p.sa_simplesearch(ord("e")) == got[0]


# --- counterparts of tests/test_partitioned.py -----------------------------

def test_boundary_match_repaired():
    text = b"I am at the. tor house"
    p = st.PartitionedSuffixArray(text, 2, device="cpu")
    m = p.longest_substring_match(b"tor")
    assert m.len == 3
    assert m.as_bytes() == b"tor"


def test_equivalent_across_partition_counts():
    text = b"it is time, gentlemen; time to go home, time to sleep, time flies"
    full = st.build_suffix_array(text, device="cpu")
    needles = [b"time to", b"gentle", b"sleep, time flies away", b"zzz", b"t"]
    want = [full.longest_substring_match(nd).len for nd in needles]
    for parts in PARTS:
        p = st.PartitionedSuffixArray(text, parts, device="cpu")
        got = [p.longest_substring_match(nd).len for nd in needles]
        assert got == want, (parts, got, want)
        for nd in needles:
            m = p.longest_substring_match(nd)
            assert text[m.start : m.start + m.len] == nd[: m.len]


def test_non_divisible_lengths_and_padding():
    rng = np.random.default_rng(11)
    text = bytes(rng.integers(0, 8, 101, dtype=np.uint8))
    full = st.build_suffix_array(text, device="cpu")
    for parts in (2, 3, 4):
        p = st.PartitionedSuffixArray(text, parts, device="cpu")
        for _ in range(10):
            start = int(rng.integers(0, 95))
            ln = int(rng.integers(1, 7))
            needle = text[start : start + ln]
            m = p.longest_substring_match(needle)
            f = full.longest_substring_match(needle)
            assert m.len == f.len == len(needle), (parts, needle)
            assert text[m.start : m.start + m.len] == needle


def test_padding_never_matches_fake_bytes():
    p = st.PartitionedSuffixArray(b"abcdefg", 2, device="cpu")  # pad 1 zero
    assert p.longest_substring_match(b"\x00\x00").len == 0


def test_num_partitions_accessor():
    p = st.PartitionedSuffixArray(b"hello world", 3, device="cpu")
    assert p.num_partitions() == 3
    assert isinstance(p, st.StringIndex)
    with pytest.raises(ValueError):
        st.PartitionedSuffixArray(b"hello", 0, device="cpu")


def test_batched_queries():
    text = b"abcabcabd" * 30
    p = st.PartitionedSuffixArray(text, 4, device="cpu")
    ms = p.longest_substring_match_batch([b"abcabd", b"bd" * 3, b"xyz"])
    assert ms[0].len == 6
    assert ms[2].len == 0
    assert p.longest_substring_match_batch([]) == []
    assert p.sa_search_batch([]) == []


def test_zero_needle_pad_suffix_regression():
    """With a padded last chunk the all-zero pad suffixes take the first
    SA slots and hijacked the binary-search candidate for zero-leading
    needles, and pad zeros inflated chunk-space match lengths near the
    chunk end. Replays the committed crasher: any needle with an
    in-partition optimal occurrence gets the full-index match length."""
    from stringsearch_torch.harness.fuzz import _check_partitioned

    path = os.path.join(CORPUS_DIR,
                        "crash-5dda27cbb7c0dab35e49099e851dbc00edc1a4fe")
    with open(path, "rb") as f:
        data = f.read()
    assert _check_partitioned(data, device="cpu") is None
    full = st.build_suffix_array(data, device="cpu")
    part = st.PartitionedSuffixArray(data, 2, device="cpu")
    for nd in (b"\x00", b"\x00\x00", b"\x00\x00\x00"):
        got = part.longest_substring_match(nd)
        want = full.longest_substring_match(nd)
        assert got.len == want.len, nd
        assert data[got.start : got.start + got.len] == nd[: got.len]


def test_partitioned_sa_search_counts():
    """In-partition counts: equal to the brute-force per-partition count,
    <= the full-text count, equal when no occurrence crosses a boundary."""
    rng = np.random.default_rng(77)
    text = bytes(rng.integers(0, 4, 600, dtype=np.uint8))
    for nparts in (1, 2, 3, 4):
        p = st.PartitionedSuffixArray(text, nparts, device="cpu")
        needles = [text[i : i + k] for i, k in
                   [(5, 2), (100, 3), (0, 1), (250, 6), (590, 10)]]
        needles += [b"\x05\x06", b"\x00", b"\x03\x03\x03", b""]
        got = p.sa_search_batch(needles)
        jgot = _jax().PartitionedSuffixArray(text, nparts).sa_search_batch(
            needles)
        assert got == jgot
        for nd, (count, first) in zip(needles[:-1], got):
            want_pos = _brute_in_partition(text, nd, p.partition_size)
            assert count == len(want_pos), (nparts, nd, count, len(want_pos))
            assert first == (min(want_pos) if want_pos else -1)
        assert got[-1] == (600, 0)  # the empty needle


def test_partitioned_sa_search_pad_duplicates_not_counted():
    """The last partition's pad slots duplicate its smallest real suffix;
    those duplicates must not inflate counts."""
    text = b"aaaa aaaa aa"  # 12 bytes -> parts of 5/5/2 with 3 pad slots
    p = st.PartitionedSuffixArray(text, 3, device="cpu")
    assert p.sa_search(b"a") == (text.count(b"a"), 0)
    count, _first = p.sa_search(b"aa")
    assert count == len(_brute_in_partition(text, b"aa", p.partition_size))


def test_partitioned_simplesearch_matches_full_text():
    rng = np.random.default_rng(3)
    text = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    p = st.PartitionedSuffixArray(text, 4, device="cpu")
    for c in (0, 65, 255, text[0]):
        count, first = p.sa_simplesearch(c)
        assert count == text.count(bytes([c]))
        assert first == (text.find(bytes([c])) if count else -1)


def test_empty_text_and_callable_engine():
    p = st.PartitionedSuffixArray(b"", 3, device="cpu")
    assert p.longest_substring_match(b"abc").len == 0
    assert p.sa_search(b"a") == (0, -1)
    text = TEXTS["random-420"]
    by_name = st.PartitionedSuffixArray(text, 3, engine="oracle",
                                        device="cpu")
    by_fn = st.PartitionedSuffixArray(text, 3, engine=doubling.sort,
                                      device="cpu")
    assert torch.equal(by_name.sas, by_fn.sas)


# --- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_build_partitioned_on_the_card(cuda, name, parts):
    radix_sort.launches = 0
    bitonic.launches = 0
    text = TEXTS[name]
    p = st.PartitionedSuffixArray(text, parts, device=cuda)
    launches = radix_sort.launches
    assert bitonic.launches == 0
    assert p.sas.device.type == "cuda"
    want = st.PartitionedSuffixArray(text, parts, device="cpu")
    assert torch.equal(p.sas.cpu(), want.sas)
    # as many sorts as the same build on the CPU makes: no factor P
    if p.partition_size * parts >= 2:
        assert launches > 0
    _check_sas(text, parts, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 3, 4])
def test_queries_on_the_card_equal_the_cpu(cuda, parts):
    rng = np.random.default_rng(5)
    text = rng.integers(97, 117, 40000, dtype=np.uint8).tobytes()
    needles = [b"e", b"ee", b"zz", text[100:104], text[39990:], b""]
    needles += [text[s : s + 9] for s in rng.integers(0, 39000, 40).tolist()]
    p = st.PartitionedSuffixArray(text, parts, device=cuda)
    q = st.PartitionedSuffixArray(text, parts, device="cpu")
    assert p.sa_search_batch(needles) == q.sa_search_batch(needles)
    got = p.longest_substring_match_batch(needles)
    want = q.longest_substring_match_batch(needles)
    assert [(g.start, g.len) for g in got] == [(w.start, w.len) for w in want]


@pytest.mark.cuda
def test_tie_between_partitions_on_the_card(cuda):
    text = b"xxabcdyy" + b"zzabcdww" + b"abcdabcd"
    p = st.PartitionedSuffixArray(text, 3, device=cuda)
    m = p.longest_substring_match(b"abcd")
    assert (m.start, m.len) == (2, 4)


@pytest.mark.cuda
def test_search_never_allocates_the_mask_on_the_card(cuda):
    """256 needles, one of them a frequent byte, on a 2^24 index: the peak
    of a search stays under the build's own peak, far below the B * n
    elements of a [B, P, L] mask."""
    from stringsearch_torch.harness.corpus import enwik_like

    n = 1 << 24
    data = enwik_like(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    p = st.PartitionedSuffixArray(data, 4, device=cuda)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - before
    rng = np.random.default_rng(8)
    needles = [b"e"] + [data[s : s + 6] for s in
                        rng.integers(0, n - 6, 255).tolist()]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = p.sa_search_batch(needles)
    torch.cuda.synchronize()
    search_peak = torch.cuda.max_memory_allocated() - held
    assert search_peak < build_peak
    assert search_peak < 16 * n  # the mask alone would be 256 * n bytes
    assert got[0] == (data.count(b"e"), data.find(b"e"))

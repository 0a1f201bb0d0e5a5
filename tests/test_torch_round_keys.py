"""A full round's sort keys in the bits their values need
(`engines/doubling.py:_round_keys`, `ops/steps.py:dense_ranks` and
`shift_planes`' `lift`).

On the CPU: every full round with the keys `_round_keys` picks gives the
same sorted order, head-slot ranks and tied count as the round with head
slots and negative markers, round after round until the text resolves,
and the radix passes it reckons are those the sort's plan
(`radix_sort.plan`, split as `device_sort` splits a sort on CUDA) marks
live; full builds equal the JAX package's; the rule on numbers alone;
the plain `dense_ranks`, the lifted markers and the packed counts of
`head_ranks` against their definitions. Every value is an integer:
tolerance 0.

Tests marked `cuda` hold the kernels against their plain versions on the
card and the engine's reckoning against the plan `sort_plan_kernel`
writes, and skip without one; run them with
`python -m pytest --noconftest -m cuda tests/test_torch_round_keys.py`
(this file imports jax only inside the tests that compare with it).
"""

import ctypes

import numpy as np
import pytest
import torch

from stringsearch_torch import oracle
from stringsearch_torch.engines import doubling
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import radix_sort, steps
from stringsearch_torch.ops.bitonic import _key_words

N = 4096
FAN = 4
DEPTH = 12


def fibonacci(n: int) -> np.ndarray:
    a, b = np.array([97], np.uint8), np.array([97, 98], np.uint8)
    while b.size < n:
        a, b = b, np.concatenate([b, a])
    return b[:n]


def thue_morse(n: int) -> np.ndarray:
    bits = np.array([bin(i).count("1") & 1 for i in range(n)], np.uint8)
    return 97 + bits


TEXTS = {
    "fibonacci": lambda: fibonacci(N),
    "thue-morse": lambda: thue_morse(N),
    "periodic": lambda: np.frombuffer((b"abcab" * N)[:N], np.uint8).copy(),
    "enwik_like": lambda: np.frombuffer(enwik_like(N), np.uint8).copy(),
    "random": lambda: np.random.default_rng(3).integers(
        0, 256, N).astype(np.uint8),
}
# (text, chunk, idx, ints): the partitioned build, int64 indexes and
# `build_ints_with_isa` beside the flat int32 builds
CASES = {name: (name, None, torch.int32, False) for name in TEXTS}
CASES.update({
    "fibonacci, chunk": ("fibonacci", N // 4, torch.int32, False),
    "fibonacci, int64": ("fibonacci", None, torch.int64, False),
    "random ints": (None, None, torch.int32, True),
})
# the cases whose rounds must take dense keys at least once
DENSE = {"fibonacci", "thue-morse", "periodic", "fibonacci, chunk",
         "fibonacci, int64", "random ints"}


def _ints() -> np.ndarray:
    return np.random.default_rng(8).integers(0, 3, N)


def _as_tensor(text: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(text.copy())


def _plan_passes(ops: tuple, num_keys: int) -> int:
    """The passes the radix sort's plan marks live in `device_sort(ops,
    num_keys)` on CUDA: one sort of up to six int32 planes, else one sort
    a group of five key words from the last (`wide_sort`)."""
    if len(ops) <= 6 and all(o.dtype == torch.int32 for o in ops):
        return sum(radix_sort.plan(ops, num_keys)[1])
    words = [w for o in ops[:num_keys] for w in _key_words(o)]
    total = 0
    for end in range(len(words), 0, -5):
        group = tuple(words[max(end - 5, 0):end])
        total += sum(radix_sort.plan(group + (group[0],), len(group))[1])
    return total


def _initial(case: str):
    """The case's initial sorted state: (sa_s, rank_s, count_t, h0,
    chunk)."""
    name, chunk, idx, ints = CASES[case]
    if ints:
        seq = torch.from_numpy(_ints()).to(torch.int32)
        depth = 4
        planes = steps.shift_planes(seq, range(1, depth))
        out = doubling.device_sort((seq, *planes), num_keys=depth)
        return (*steps.head_ranks(out), depth, None)
    text = _as_tensor(TEXTS[name]())
    sa_s, rank_s, count = doubling._initial_sorted(text, DEPTH, chunk, idx)
    return sa_s, rank_s, count, DEPTH, chunk


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_key_rounds_equal_head_slot_rounds(case):
    sa_s, rank_s, count_t, h, chunk = _initial(case)
    n = sa_s.shape[0]
    c = steps.chunk_len(n, chunk)
    wide = sa_s.dtype == torch.int64
    count, groups = steps.read_counts(count_t)
    assert count == int(count_t)
    assert groups == int((rank_s == torch.arange(n)).sum())
    keys_seen = []
    for _ in range(40):
        if not count:
            break
        shifts = doubling._round_shifts(h, FAN, c)
        dense, lifts, passes = doubling._round_keys(groups, n, c, shifts,
                                                    wide)
        keys_seen.append(dense)
        keys = steps.dense_ranks(rank_s) if dense else rank_s
        rank = doubling._scatter_to_text_order(sa_s, keys)
        planes = steps.shift_planes(rank, shifts, c, lifts)
        assert passes == _plan_passes((rank, *planes), FAN)
        got = doubling._full_round_sorted(rank, h, FAN, chunk, lifts)
        want = doubling._full_round_sorted(
            doubling._scatter_to_text_order(sa_s, rank_s), h, FAN, chunk)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert int(got[2]) == int(want[2])
        sa_s, rank_s = got[:2]
        count, groups = steps.read_counts(got[2])
        h = doubling._next_h(h, c, FAN)
    assert count == 0
    assert any(keys_seen) == (case in DENSE)


@pytest.mark.parametrize("case", sorted(CASES))
def test_builds_equal_the_jax_package(case):
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    name, chunk, idx, ints = CASES[case]
    if ints:
        seq = _ints()
        sa, isa = doubling.build_ints_with_isa(seq, device="cpu")
        jsa, jisa = jdoubling.build_ints_with_isa(jnp.asarray(seq))
        np.testing.assert_array_equal(isa.numpy(), np.asarray(jisa))
        np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
        return
    text = TEXTS[name]()
    sa = doubling.build_sa(_as_tensor(text), idx=idx, depth=DEPTH,
                           chunk=chunk)
    assert sa.dtype == idx
    c = chunk or N
    for p in range(N // c):
        jsa, _ = jdoubling.build_with_isa(jnp.asarray(text[p * c:(p + 1) * c]),
                                          depth=DEPTH)
        np.testing.assert_array_equal(
            sa.numpy()[p * c:(p + 1) * c] - p * c, np.asarray(jsa))
    if chunk is None:
        np.testing.assert_array_equal(sa.numpy(), oracle.build(text))


FIB41 = 267914296


def _fib41_total() -> int:
    """The reckoned passes of the Fibonacci word's twelve full rounds at
    fib41's size, its groups twice the depth a round starts from."""
    total, h = 0, DEPTH
    for _ in range(12):
        total += doubling._round_keys(2 * h, FIB41, FIB41,
                                      doubling._round_shifts(h, FAN, FIB41),
                                      False)[2]
        h = doubling._next_h(h, FIB41, FAN)
    return total


# (groups, n, chunk, shifts, wide) -> (dense, lifts, passes), by hand
RULES = {
    # fib41's first round: 24 groups, one digit a plane, against 4
    "fib41, round 1": ((24, FIB41, FIB41, (12, 24, 36), False),
                       (True, [True] * 3, 4)),
    # 2^24 - 1 groups: plane 0 and the shift-1 plane take 3 digits, the
    # others 4 with negative markers; head slots take 4 everywhere
    "just under 2^24": (((1 << 24) - 1, 1 << 28, 1 << 28, (1, 2, 3), False),
                        (True, [True, False, False], 14)),
    # from 2^24 groups on, head slots
    "2^24 groups": ((1 << 24, 1 << 28, 1 << 28, (1, 2, 3), False),
                    (False, [False] * 3, 16)),
    # two digits a plane either way: a tie keeps head slots
    "a tie": ((500, 1000, 1000, (10, 20, 30), False),
              (False, [True] * 3, 8)),
    # every shift past the chunk: markers only, [0, 1000)
    "markers only": ((600, 1000, 1000, (1000, 1000, 1000), False),
                     (False, [True] * 3, 8)),
    # int64 planes: two words each, sorted five at a time; a dense
    # plane's high word is dead, a negative marker's live
    "int64": ((24, 1 << 28, 1 << 28, (12, 24, 36), True),
              (True, [True] * 3, 4)),
    "int64, head slots": ((1 << 24, 1 << 28, 1 << 28, (12, 24, 36), True),
                          (False, [False] * 3, 28)),
}


@pytest.mark.parametrize("rule", sorted(RULES) + ["fib41, every round"])
def test_the_rule_takes_the_keys_with_fewer_passes(rule):
    if rule == "fib41, every round":
        # 4, 4, 8 x 4, 12 x 4, 16 x 2: 120 passes, against 12 x 16
        assert _fib41_total() == 120
        return
    args, want = RULES[rule]
    assert doubling._round_keys(*args) == want


def _dense_definition(rank_s: list) -> list:
    out, heads = [], 0
    for j, r in enumerate(rank_s):
        heads += r == j
        out.append(heads - 1)
    return out


def _lift_definition(rank: list, s: int, chunk: int) -> list:
    n = len(rank)
    s = min(s, chunk)
    return [rank[i + s] + s if i % chunk + s < chunk else chunk - 1 - i % chunk
            for i in range(n)]


def _sorted_ranks(keys: np.ndarray) -> torch.Tensor:
    order = np.argsort(keys, kind="stable")
    out = [torch.from_numpy(keys[order].astype(np.int32)),
           torch.from_numpy(order.astype(np.int32))]
    return steps.plain_head_ranks(out)


DEFINITIONS = ["dense: random groups", "dense: all heads", "dense: one group",
               "dense: empty", "dense: in place", "lift: flat",
               "lift: chunks", "lift: int64", "counts"]


@pytest.mark.parametrize("what", DEFINITIONS)
def test_plain_versions_match_their_definitions(what):
    rng = np.random.default_rng(11)
    if what.startswith("dense"):
        random = _sorted_ranks(rng.integers(0, 40, 700))[1]
        rank_s = {
            "dense: random groups": random,
            "dense: all heads": torch.arange(300, dtype=torch.int32),
            "dense: one group": torch.zeros(300, dtype=torch.int64),
            "dense: empty": torch.zeros(0, dtype=torch.int32),
            "dense: in place": random.clone(),
        }[what]
        want = _dense_definition(rank_s.tolist())
        if what == "dense: in place":
            assert steps.dense_ranks(rank_s, out=rank_s) is rank_s
            assert rank_s.tolist() == want
            with pytest.raises(ValueError):
                steps.dense_ranks(rank_s, out=rank_s.to(torch.int64))
            return
        got = steps.dense_ranks(rank_s)
        assert got.dtype == rank_s.dtype
        assert got.tolist() == want
        assert torch.equal(got, steps.plain_dense_ranks(rank_s))
    elif what.startswith("lift"):
        idx = torch.int64 if what == "lift: int64" else torch.int32
        chunk = 25 if what == "lift: chunks" else None
        rank = torch.from_numpy(rng.integers(0, 1000, 100)).to(idx)
        shifts = [0, 1, 7, 24, 25, 30, 100, 150]
        lifts = [s % 2 == 0 for s in range(len(shifts))]
        got = steps.shift_planes(rank, shifts, chunk, lifts)
        plain = steps.plain_shift_planes(rank, shifts, chunk)
        c = chunk or 100
        for g, s, up, p in zip(got, shifts, lifts, plain):
            assert g.dtype == idx
            if up:
                assert g.tolist() == _lift_definition(rank.tolist(), s, c)
            else:
                assert torch.equal(g, p)
        assert got[-1].tolist() == list(range(100))
        every = steps.shift_planes(rank, shifts, chunk, True)
        assert [g.tolist() for g in every[:-1]] == [
            _lift_definition(rank.tolist(), s, c) for s in shifts]
    else:
        sa_s, rank_s, count = _sorted_ranks(rng.integers(0, 40, 700))
        tied, groups = steps.read_counts(count)
        assert count.dim() == 0 and tied == int(count)
        assert groups == len(set(rank_s.tolist())) == 40
        heads = rank_s.tolist()
        assert tied == sum(heads.count(h) for h in set(heads)
                           if heads.count(h) > 1)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    steps.load_library()
    return torch.device("cuda")


def _dense_cases(n: int, idx, device) -> dict:
    """Head-slot ranks of sorted orders with random groups, every slot a
    head, one group, and groups that start only at tile starts."""
    g = torch.Generator().manual_seed(n)
    keys = torch.sort(torch.randint(0, max(n // 3, 1), (n,), generator=g))[0]
    starts = (torch.arange(n) // steps.DENSE_TILE) * steps.DENSE_TILE
    cases = {
        "random groups": steps.plain_head_ranks(
            [keys.to(torch.int32), torch.arange(n, dtype=torch.int32)])[1],
        "all heads": torch.arange(n),
        "one group": torch.zeros(n, dtype=torch.int64),
        "tile starts": starts,
    }
    return {k: v.to(idx).to(device) for k, v in cases.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 2, 3, steps.DENSE_TILE - 1,
                               steps.DENSE_TILE, steps.DENSE_TILE + 1,
                               64 * steps.DENSE_TILE + 5, (1 << 20) + 12345])
def test_dense_ranks_kernel_equals_plain(cuda, n, idx):
    for name, rank_s in _dense_cases(n, idx, cuda).items():
        before = steps.launches["dense_ranks"]
        got = steps.dense_ranks(rank_s)
        torch.cuda.synchronize()
        assert steps.launches["dense_ranks"] == before + 1, name
        want = steps.plain_dense_ranks(rank_s)
        assert got.device.type == "cuda" and got.dtype == idx, name
        assert torch.equal(got, want), name
        # in place of the head slots, as the round loop writes them
        assert torch.equal(steps.dense_ranks(rank_s, out=rank_s), want), name


@pytest.mark.cuda
def test_dense_ranks_kernel_on_long_runs(cuda):
    """2^24 slots in one group and all heads: the longest look-backs of
    counts and the largest counts."""
    n = 1 << 24
    for rank_s in (torch.zeros(n, dtype=torch.int32, device=cuda),
                   torch.arange(n, dtype=torch.int32, device=cuda)):
        assert torch.equal(steps.dense_ranks(rank_s),
                           steps.plain_dense_ranks(rank_s))


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 3, steps.SHIFT_TILE + 1, (1 << 20) + 12345])
def test_lifted_shift_planes_kernel_equals_plain(cuda, n, idx):
    g = torch.Generator().manual_seed(n)
    rank = torch.randint(0, 1 << 20, (n,), generator=g).to(idx).to(cuda)
    shifts = [0, 1, 12, 24, 36, n // 2, n, n + 5, 3, 4]
    for chunk in [None] + ([n // 4] if n % 4 == 0 and n > 4 else []):
        for lifts in ([True] * len(shifts),
                      [s % 3 == 0 for s in range(len(shifts))]):
            got = steps.shift_planes(rank, shifts, chunk, lifts)
            want = steps.plain_shift_planes(rank, shifts, chunk, lifts)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == idx and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 2, steps.SCAN_TILE + 1, (1 << 20) + 12345])
def test_head_ranks_kernel_counts_the_groups(cuda, n, idx):
    g = torch.Generator().manual_seed(n)
    keys = torch.sort(torch.randint(0, max(n // 5, 1), (n,), generator=g))[0]
    out = [keys.to(idx).to(cuda), torch.arange(n, dtype=idx, device=cuda)]
    got = steps.head_ranks(out)
    want = steps.plain_head_ranks(out)
    assert torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2]) and got[2].dim() == 0
    assert steps.read_counts(got[2]) == steps.read_counts(want[2])
    # the global build's shards: no group count asked for, outputs as
    # their plain version's
    for prev in (None, keys[:1].to(torch.int64).to(cuda) - 1):
        heads, count = steps.shard_head_ranks(out[:1], prev, 100, idx)
        wheads, wcount = steps.plain_shard_head_ranks(out[:1], prev, 100, idx)
        assert torch.equal(heads, wheads) and count.dim() == 0
        assert int(count) == int(wcount)


def _kernel_live(planes: tuple, num_keys: int) -> int:
    """The passes `sort_plan_kernel` marks live in a radix sort of the int32
    CUDA `planes`: its plan, one int4 {live, from, to, 0} a pass, is the
    last kMaxPasses (24) int4 of the sort's scratch."""
    lib = radix_sort.LIBRARY
    n = planes[0].shape[0]
    set_a = [torch.empty_like(p) for p in planes]
    set_b = [torch.empty_like(p) for p in planes]
    scratch = torch.empty((lib.load().ss_radix_sort_scratch_ints(n),),
                          dtype=torch.int32, device=planes[0].device)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    lib.call("ss_radix_sort_i32", planes[0].device, ptrs(planes),
             ptrs(set_a), ptrs(set_b), scratch.data_ptr(), len(planes), n,
             num_keys)
    plan = scratch[-24 * 4:].view(24, 4)
    return int(plan[:4 * num_keys, 0].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("text", ["fibonacci", "enwik_like"])
def test_round_passes_equal_the_kernel_plan(cuda, text, monkeypatch):
    """The engine's reckoning of every full round at 2^24 against the
    plan the sort's kernel writes for that round's keys. The enwik-class
    text runs full rounds down to 64 tied (levels (2^24,))."""
    n = 1 << 24
    data = (fibonacci(n) if text == "fibonacci"
            else np.frombuffer(enwik_like(n), np.uint8))
    reckoned, planned = [], []
    keys, sort = doubling._round_keys, doubling.device_sort

    def spy_keys(*args):
        out = keys(*args)
        reckoned.append(out[2])
        return out

    def spy_sort(ops, num_keys=1):
        ops = tuple(ops)
        if num_keys == FAN and len(ops) == FAN + 1:
            planned.append(_kernel_live(tuple(o.contiguous() for o in ops),
                                        num_keys))
        return sort(ops, num_keys)

    monkeypatch.setattr(doubling, "_round_keys", spy_keys)
    monkeypatch.setattr(doubling, "device_sort", spy_sort)
    sa = doubling.build_sa(torch.from_numpy(data.copy()).to(cuda),
                           depth=DEPTH, levels=(n,))
    monkeypatch.undo()
    assert reckoned and reckoned == planned
    want = doubling.build_sa(torch.from_numpy(data.copy()).to(cuda),
                             depth=DEPTH)
    assert torch.equal(sa, want)

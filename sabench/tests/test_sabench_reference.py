import numpy as np
import pytest
import torch

from sabench import reference

TEXTS = [b"banana", b"mississippi", b"aaaaaaaaaa", b"abababababab",
         b"a", b"ab", b"ba", b"\x00\x00\x01\x00", bytes(range(256)) * 3]


def brute_sa(text: bytes) -> np.ndarray:
    return np.array(sorted(range(len(text)), key=lambda i: text[i:]),
                    dtype=np.int32)


def t(b: bytes) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8)


def random_texts():
    rng = np.random.default_rng(4)
    out = []
    for n, alpha in [(50, 2), (200, 3), (500, 4), (1000, 256), (3000, 2)]:
        out.append(bytes(rng.integers(0, alpha, n, dtype=np.uint8)))
    out.append(b"abcab" * 100 + b"abcac" + b"abcab" * 100)
    return out


@pytest.mark.parametrize("text", TEXTS + random_texts())
def test_check_sa_accepts_the_suffix_array(text):
    sa = torch.from_numpy(brute_sa(text))
    assert reference.check_sa(t(text), sa, block=7) == {
        "sa_not_perm": 0, "sa_bad_pairs": 0}


@pytest.mark.parametrize("text", [x for x in TEXTS if len(x) > 2]
                         + random_texts())
def test_check_sa_rejects_a_swapped_pair(text):
    sa = torch.from_numpy(brute_sa(text))
    for i in (0, len(text) // 2, len(text) - 2):
        bad = sa.clone()
        bad[i], bad[i + 1] = sa[i + 1].item(), sa[i].item()
        got = reference.check_sa(t(text), bad)
        assert got["sa_bad_pairs"] > 0 and got["sa_not_perm"] == 0


@pytest.mark.parametrize("text", [x for x in TEXTS if len(x) > 1]
                         + random_texts())
def test_check_sa_rejects_an_entry_off_by_one(text):
    sa = torch.from_numpy(brute_sa(text))
    for i in (0, len(text) - 1):
        bad = sa.clone()
        bad[i] = (bad[i] + 1) % len(text)
        got = reference.check_sa(t(text), bad)
        assert got["sa_not_perm"] > 0
    short = reference.check_sa(t(text), sa[:-1])
    assert short["sa_not_perm"] > 0


@pytest.mark.parametrize("text", TEXTS + random_texts())
def test_doubling_sa_is_the_suffix_array(text):
    got = reference.doubling_sa(t(text)).numpy()
    assert np.array_equal(got, brute_sa(text))


def test_doubling_short_breaks_the_order():
    from sabench.generators import fibonacci

    fib = bytes(fibonacci.word(121393, "cpu").numpy())
    for text in [b"abcab" * 100 + b"abcac" + b"abcab" * 100,
                 random_texts()[-2], fib]:
        short = reference.doubling_sa(t(text), short=2)
        assert reference.check_sa(t(text), short)["sa_bad_pairs"] > 0
    # one round short leaves the Fibonacci word's ties in the right order
    one = reference.doubling_sa(t(fib), short=1)
    assert reference.check_sa(t(fib), one)["sa_bad_pairs"] == 0


def test_digest_sees_a_swap_and_a_change():
    n = 4096 * 3 + 17
    sa = torch.randperm(n, generator=torch.Generator().manual_seed(1)).to(
        torch.int32)
    digest = reference.Digest(n, "cpu")
    want = digest(sa)
    assert torch.equal(digest(sa.clone()), want)
    for i, j in [(0, 1), (5, 4096 + 5), (100, 4096 * 2 + 900), (n - 2, n - 1),
                 (7, n - 1)]:
        bad = sa.clone()
        bad[i], bad[j] = sa[j].item(), sa[i].item()
        assert not torch.equal(digest(bad), want)
    bad = sa.clone()
    bad[77] += 1
    assert not torch.equal(digest(bad), want)

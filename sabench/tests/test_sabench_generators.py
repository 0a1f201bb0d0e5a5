import numpy as np
import pytest
import torch

from sabench.generators import enwik

ENWIK = {"text_bytes": 1 << 16}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 12345678901234])
def test_enwik_is_a_function_of_the_seed(seed):
    a = enwik.make(ENWIK, seed, "cpu")
    b = enwik.make(ENWIK, seed, "cpu")
    c = enwik.make(ENWIK, seed + 1, "cpu")
    assert a.dtype == torch.uint8 and a.numel() == 1 << 16
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("n", [1, 4095, 100_003])
def test_enwik_in_pieces_is_exact_and_a_function_of_the_seed(n, monkeypatch):
    monkeypatch.setattr(enwik, "PIECE_PAIRS", 1024)
    a = enwik.make({"text_bytes": n}, 5, "cpu")
    assert a.numel() == n and torch.equal(a, enwik.make({"text_bytes": n},
                                                        5, "cpu"))


def test_enwik_keeps_enwik_like_statistics():
    from stringsearch_torch.harness.corpus import enwik_like

    n = 1 << 20
    ours = enwik.make({"text_bytes": n}, 3, "cpu")
    theirs = np.frombuffer(enwik_like(n, 3), np.uint8)
    h1 = np.bincount(ours.numpy(), minlength=256) / n
    h2 = np.bincount(theirs, minlength=256) / n
    assert np.abs(h1 - h2).sum() < 0.02
    assert enwik.vocabulary()[:3] == [b"the", b"of", b"and"]


@pytest.mark.cuda
def test_enwik_on_the_card_is_a_function_of_the_seed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = {"text_bytes": 1 << 24}
    a = enwik.make(config, 99, "cuda")
    b = enwik.make(config, 99, "cuda")
    assert torch.equal(a, b)

"""The build kind's warm-up: `warmup` builds, and one more after each build
that made the caching allocator retry, up to `warmup` more, so that the
window starts with an allocator that no longer frees and allocates."""

import os

import pytest
import torch

from sabench import run, spec

KIND = os.path.join(os.path.dirname(os.path.dirname(__file__)), "kinds",
                    "build.py")


class Counting:
    """A program whose builds make the allocator retry where told."""

    def __init__(self, retry_in):
        self.retry_in, self.builds, self.retries = set(retry_in), 0, 0

    def build(self, text):
        if self.builds in self.retry_in:
            self.retries += 1
        self.builds += 1
        return torch.arange(text.numel(), dtype=torch.int32)


@pytest.mark.parametrize("retry_in,builds", [
    ((), 2),            # nothing retries: the minimum
    ((0,), 2),          # the second build follows the retry
    ((1,), 3),          # as a 10^9 B text on an 80 GB card
    ((1, 2), 4),
    (range(99), 4),     # every build retries: at most `warmup` more
])
def test_a_retry_buys_one_more_warm_up_build(monkeypatch, retry_in, builds):
    kind = spec.load_module(KIND)
    program = Counting(retry_in)
    monkeypatch.setattr(kind, "alloc_retries", lambda device: program.retries)
    cpu = torch.device("cpu")
    text = torch.randint(97, 100, (64,), dtype=torch.uint8)
    ctx = run.Context(text, {}, {"warmup": 2}, 0, program, cpu, [cpu])
    kind.Job(ctx)
    assert program.builds == builds


def test_no_retries_off_cuda():
    kind = spec.load_module(KIND)
    assert kind.alloc_retries(torch.device("cpu")) == 0

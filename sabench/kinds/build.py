"""Build traffic: back-to-back builds of the suffix array of one text.

A unit is one `build_suffix_array` of the text on the device, ending in
a synchronize; its work is the text's bytes. Set-up makes `warmup`
builds, and one more after each that made the caching allocator retry
(free its cached blocks and allocate again), up to `warmup` more: the
first build of a process was up to 1.8 times slower than the next, and
at 10^9 B, near the card's capacity, the second build retries and the
third allocates five blocks anew, up to 0.6 s slower where it fell
inside the window; from the fourth on a build allocates nothing. Every
build's suffix array is folded into a `Digest` as it comes out (outside
the build's own wall, inside the window: about a millisecond a build at
2^28 B, part of what `build_Bps` measures); the last is kept and judged
in full once the window has closed, and every build's digest must equal
the digest of the one judged.

Traffic keys: `warmup` (builds in set-up),
`trace_units` (builds under the profiler in a traced run).
"""

from __future__ import annotations

import sys
import time

import torch

from sabench import reference


def alloc_retries(device) -> int:
    """The caching allocator's count of out-of-memory retries on
    `device` so far (0 off CUDA)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


class Job:
    kind = "build"

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.text.numel()
        self.digest = reference.Digest(self.n, ctx.device)
        self.digests = []
        self.sa = None
        warmup = int(ctx.traffic["warmup"])
        walls, retried = [], False
        while len(walls) < warmup or (retried and len(walls) < 2 * warmup):
            retries = alloc_retries(ctx.device)
            self.sa = None
            t0 = time.perf_counter()
            self.sa = ctx.program.build(ctx.text)
            ctx.sync()
            walls.append(time.perf_counter() - t0)
            retried = alloc_retries(ctx.device) > retries
        print(f"warm-up builds: {[round(w, 4) for w in walls]} s",
              file=sys.stderr, flush=True)
        self.digest(self.sa)  # the digest's own kernels, loaded once here
        self.sa = None
        ctx.sync()

    def unit(self) -> tuple[float, float, int]:
        self.sa = None  # the program's peak, not one SA more
        t0 = time.perf_counter()
        sa = self.ctx.program.build(self.ctx.text)
        self.ctx.sync()
        t1 = time.perf_counter()
        self.digests.append(self.digest(sa))
        self.sa = sa
        return t0, t1, self.n

    def release(self) -> None:
        """Drop what the program holds but the outputs to judge."""
        self.ctx.program = None

    def judge(self) -> tuple[int, int, dict]:
        """(attempted, failed, {check: (value, limit)})."""
        got = reference.check_sa(self.ctx.text, self.sa)
        want = self.digest(self.sa)
        differ = sum(not torch.equal(d, want) for d in self.digests)
        attempted = len(self.digests)
        sound = got["sa_not_perm"] == 0 and got["sa_bad_pairs"] == 0
        failed = differ if sound else attempted
        checks = {"sa_not_perm": (got["sa_not_perm"], 0),
                  "sa_bad_pairs": (got["sa_bad_pairs"], 0),
                  "builds_differ": (differ, 0)}
        return attempted, failed, checks

"""Global build traffic: back-to-back exact global builds of one text
over the cell's cards.

A unit is one `build_global` of the text over `make_mesh(devices=...)` of
the cell's cards, one shard a card, with the program's defaults
(`program_global.GlobalProgram`), ending in a synchronize of every card.
The program is the run's (`Context.program`): the kind puts
`GlobalProgram` in the place of the run's default, the flat index, and
takes a program that builds by shard (`sharded`, such as the global
control of `control_global.py`) as it is given; any other it refuses.
The text lies on the first card, as the context makes it, so placing the
shards on their cards is part of each build. Its work is the text's
bytes and its kind is "build", so `build_Bps` reads it as it reads a flat
build. Set-up loads the kernel libraries the global build launches and
makes `warmup` builds, and one more after each that made the caching
allocator retry on any of the cards, up to `warmup` more (the rule of
`kinds/build.py`). Every build's suffix array is folded into a
`reference_global.ShardDigest` as it comes out, each piece on its own
card (outside the build's own wall, inside the window, as `kinds/build.py`
digests). Once the window has closed and the program's state is dropped,
the last build's pieces are put together on the first card and judged in
full with `reference.check_sa`, and every build's digest must equal
`reference.Digest` of the array judged.

Traffic keys: `warmup` (builds in set-up), `trace_units` (builds under
the profiler in a traced run).
"""

from __future__ import annotations

import sys
import time

import torch

from sabench import reference, reference_global, spec
from sabench.kinds.build import alloc_retries


def sharded_program(ctx):
    """The program that builds the cell: `ctx.program` where it builds by
    shard, a `GlobalProgram` where it is the run's default, bound to the
    cell's cards."""
    from sabench.program import Program
    from sabench.program_global import GlobalProgram

    program = ctx.program
    if type(program) is Program:
        program = GlobalProgram()
        if ctx.device.type == "cuda":
            program.load_kernels()
    elif not getattr(program, "sharded", False):
        raise spec.SpecError(
            f"{type(program).__name__} does not build by shard: a global "
            "cell needs a program that does (sabench/program_global.py)")
    program.use(ctx.devices)
    ctx.program = program
    return program


def retries(devices) -> int:
    """The caching allocator's out-of-memory retries so far, summed over
    the distinct cards of `devices`."""
    return sum(alloc_retries(d) for d in dict.fromkeys(devices))


class Job:
    kind = "build"

    def __init__(self, ctx):
        self.ctx = ctx
        self.program = sharded_program(ctx)
        self.n = ctx.text.numel()
        self.digest = reference_global.ShardDigest(self.n, ctx.device)
        self.digests = []
        self.sa = None
        warmup = int(ctx.traffic["warmup"])
        walls, retried = [], False
        while len(walls) < warmup or (retried and len(walls) < 2 * warmup):
            before = retries(ctx.devices)
            self.sa = None
            t0 = time.perf_counter()
            self.sa = self.program.build(ctx.text)
            ctx.sync()
            walls.append(time.perf_counter() - t0)
            retried = retries(ctx.devices) > before
        print(f"warm-up builds: {[round(w, 4) for w in walls]} s",
              file=sys.stderr, flush=True)
        self.digest(self.sa)  # the digest's own kernels, loaded once here
        self.sa = None
        ctx.sync()

    def unit(self) -> tuple[float, float, int]:
        self.sa = None  # the program's peak, not one SA more
        t0 = time.perf_counter()
        sa = self.program.build(self.ctx.text)
        self.ctx.sync()
        t1 = time.perf_counter()
        self.digests.append(self.digest(sa))
        self.sa = sa
        return t0, t1, self.n

    def release(self) -> None:
        """Drop what the program holds but the outputs to judge."""
        self.ctx.program = None
        self.program = None

    def judge(self) -> tuple[int, int, dict]:
        """(attempted, failed, {check: (value, limit)})."""
        dev = self.ctx.device
        sa = torch.cat([piece.to(dev) for piece in self.sa])
        self.sa = None
        got = reference.check_sa(self.ctx.text, sa)
        want = reference.Digest(self.n, dev)(sa).cpu()
        differ = sum(not torch.equal(d, want) for d in self.digests)
        attempted = len(self.digests)
        sound = got["sa_not_perm"] == 0 and got["sa_bad_pairs"] == 0
        failed = differ if sound else attempted
        checks = {"sa_not_perm": (got["sa_not_perm"], 0),
                  "sa_bad_pairs": (got["sa_bad_pairs"], 0),
                  "builds_differ": (differ, 0)}
        return attempted, failed, checks

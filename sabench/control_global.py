"""Readings for the limits of `correct` on a global cell (one that builds
by shard over several cards, `kinds/global_build.py`): the cell run on
many seeds in one process, by the program or by its control.

    python -m sabench.control_global --workload <cell> --seeds 1,2,3 --seconds 2
    python -m sabench.control_global --workload <cell> --seeds 1,2,3 --seconds 2 --control

Each seed is one run of the cell through `run_workload` (set-up, a window
of `--seconds`, the judgment) and prints one JSON line: the seed,
`correct` and every number compared. Without `--control` the program
serves: the lower readings. With `--control` `GlobalControl` takes the
program's place: the upper readings, which must fail. `sabench.control`'s
own control builds the reference's whole suffix array on the first card,
which a global cell's text does not fit; this one works piece by piece,
each on its card. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sabench.program_global import GlobalProgram


def first_bytes_order(text, piece, depth: int):
    """`piece`, a run of the suffix array, reordered so that the suffixes
    in it that share their first `depth` bytes (a suffix's bytes past the
    text's end count as less than any byte) stand in position order."""
    n = text.numel()
    pos = piece.to(torch.int64)
    same = torch.ones(max(pos.numel() - 1, 0), dtype=torch.bool,
                      device=pos.device)
    for j in range(depth):
        at = pos + j
        byte = torch.where(at < n, text[at.clamp(max=n - 1)].to(torch.int32),
                           -1)
        same &= byte[:-1] == byte[1:]
        del at, byte
    group = torch.cat([same.new_zeros(1, dtype=torch.int64),
                       torch.cumsum(~same, 0)])
    del same
    key = group * n + pos
    del group, pos
    return (torch.sort(key).values % n).to(piece.dtype)


class GlobalControl(GlobalProgram):
    """The program's global build with exact order broken: inside each
    shard's piece the suffixes that share their first `DEPTH` bytes (the
    build's initial depth) stand in position order, the order of the
    initial sort's ties, as if no doubling round had run. The pieces stay
    a permutation, each on its card."""

    DEPTH = 16

    def __init__(self):
        super().__init__()
        self._texts = {}

    def build(self, text) -> tuple:
        out = []
        for piece in super().build(text):
            dev = piece.device
            if dev not in self._texts:
                self._texts[dev] = text.to(dev)
            out.append(first_bytes_order(self._texts[dev], piece,
                                         self.DEPTH))
        return tuple(out)


def main(argv=None) -> int:
    from sabench.run import forbidden_modules, run_workload, say

    p = argparse.ArgumentParser(prog="python -m sabench.control_global")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        say("error: no CUDA card")
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        program = GlobalControl() if args.control else GlobalProgram()
        r = run_workload(args.workload, seed, args.seconds, False,
                         program=program)
        line = {"workload": args.workload, "seed": seed,
                "control": args.control, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "checks": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        del program, r
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        say(f"error: loaded in this process: {', '.join(bad)}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the limits of `correct`: a cell run on many seeds in one
process, by the program or by its control.

    python -m sabench.control --workload <cell> --seeds 1,2,3 --seconds 2
    python -m sabench.control --workload <cell> --seeds 1,2,3 --seconds 2 --control

    python -m sabench.control --workload <cell> --seeds 1,2,3 --fault swap

Each seed is one run of the cell (set-up, a window of `--seconds`, the
judgment) and prints one JSON line: the seed, `correct` and every number
compared. Without `--control` the program serves: the lower readings. With
`--control` the reference takes the program's place with one of its
guarantees broken (`Control`): the upper readings, which must fail. With
`--fault` the program serves with its outputs altered where they are
produced (`Fault`), so that each number compared fails under something at
the cell's own size. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sabench import reference


class Control:
    """The reference in the program's place, one guarantee broken:
    `reference.doubling_sa(short=2)`, the suffix order of the doubling
    round two before the last (suffixes compared to a quarter of the depth
    the text needs, ties in position order), so exact order is broken.
    One round short is not enough on every text: in a Fibonacci word the
    suffixes still tied there are in position order already."""

    ROUNDS_SHORT = 2

    def __init__(self, program=None):
        if program is None:
            from sabench.program import Program

            program = Program()
        self._program = program

    def load_kernels(self) -> None:
        self._program.load_kernels()

    def build(self, text):
        return reference.doubling_sa(text, short=self.ROUNDS_SHORT)

    def sort_launches(self) -> int:
        return self._program.sort_launches()


class Fault:
    """The program, with one fault planted in each output as it comes out:
    "swap" exchanges two neighbouring entries of every suffix array,
    "entry" adds one to an entry, "alternate" swaps two entries in every
    other build only, so that builds of the window differ from the one
    judged in full."""

    KINDS = ("swap", "entry", "alternate")

    def __init__(self, kind: str, program=None):
        if kind not in self.KINDS:
            raise ValueError(f"no fault {kind!r} (have: {self.KINDS})")
        if program is None:
            from sabench.program import Program

            program = Program()
        self._program = program
        self._kind = kind
        self._builds = 0

    def load_kernels(self) -> None:
        self._program.load_kernels()

    def build(self, text):
        sa = self._program.build(text)
        self._builds += 1
        k = text.numel() // 3
        if self._kind == "swap" or (self._kind == "alternate"
                                    and self._builds % 2):
            sa = sa.clone()
            sa[k], sa[k + 1] = sa[k + 1].clone(), sa[k].clone()
        elif self._kind == "entry":
            sa = sa.clone()
            sa[k] = (sa[k] + 1) % text.numel()
        return sa

    def sort_launches(self) -> int:
        return self._program.sort_launches()


def main(argv=None) -> int:
    from sabench.run import forbidden_modules, run_workload, say

    p = argparse.ArgumentParser(prog="python -m sabench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=Fault.KINDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        say("error: no CUDA card")
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        program = None
        if args.control:
            program = Control()
        elif args.fault:
            program = Fault(args.fault)
        r = run_workload(args.workload, seed, args.seconds, False,
                         program=program)
        line = {"workload": args.workload, "seed": seed,
                "control": args.control, "fault": args.fault,
                "correct": r["correct"],
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

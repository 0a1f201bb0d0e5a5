"""Where a cell's traced builds spend their time, by the program's spans.

    python -m sabench.phases --workload <cell> --seed <n> [--seed <n> ...]

For each seed, the cell's set-up and traced window as a `--trace 1` run
makes them (`run.py:traced_window`, no judging), then, from the window's
trace: the cell's per-layer metrics; the engine's phases
(`stringsearch_torch/harness/profile_build.py:print_phases`, over the
spans `spans.of` reads); the device's idle in the window by the innermost
program span open on the host where each gap opens; and the idle in gaps
that open inside an `aten::_local_scalar_dense` host event (the program's
reads of a count, with spans or without), per build. A program that
records no spans prints the metrics and the last line alone. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict

import torch

from sabench import run, spans, spec

READ = "aten::_local_scalar_dense"


def gaps(tr) -> list:
    """The idle gaps (start, end) between each card's busy intervals
    inside the traced window, every card's together, in us."""
    out = []
    for card in range(tr.cards):
        busy = tr.busy_intervals(card)
        out += [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    return out


def idle_by_span(records, idle) -> dict:
    """{innermost span open where a gap opens: idle us}."""
    out = defaultdict(float)
    for g0, g1 in idle:
        inside = [s for s in records if s.start_us <= g0 <= s.end_us]
        name = max(inside, key=lambda s: s.start_us).name if inside else (
            "no span")
        out[name] += g1 - g0
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_in_reads(tr, idle) -> tuple:
    """(gaps, idle us) of the gaps that open inside a count's read."""
    reads = sorted((s, e) for name, s, e in tr.host_ops if name == READ)
    starts = [r[0] for r in reads]
    hit = []
    for g0, g1 in idle:
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and g0 <= reads[i][1]:
            hit.append(g1 - g0)
    return len(hit), sum(hit)


def one(workload: str, seed: int) -> None:
    cell = spec.load_cell(run.ROOT, workload)
    devices = run.open_devices("cuda", cell.chips)
    dev = devices[0]
    from sabench.program import Program

    program = Program()
    program.load_kernels()
    text = cell.generator.make(cell.config, seed, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    job = cell.kind.Job(run.Context(text, cell.config, cell.traffic, seed,
                                    program, dev, devices))
    tr = run.traced_window(job, program, int(cell.traffic["trace_units"]),
                           devices)
    metrics = {m.name: m.reader.read(tr) for m in cell.per_layer}
    print(f"{workload} seed {seed}: {json.dumps(metrics)}", flush=True)
    records = spans.of(tr)
    idle = gaps(tr)
    if records:
        try:
            from stringsearch_torch.harness.profile_build import print_phases
        except ImportError:
            print_phases = None
        if print_phases is not None:
            print_phases(records)
        by = idle_by_span(records, idle)
        print("   idle by span, ms a build: " + ", ".join(
            f"{k} {v / 1e3 / tr.units:.4f}" for k, v in by.items()))
    count, us = idle_in_reads(tr, idle)
    print(f"   idle in gaps that open in a count's read: {count / tr.units}"
          f" gaps, {us / 1e3 / tr.units:.4f} ms a build; window "
          f"{tr.window_us / 1e6:.6f} s, busy {tr.busy_us() / 1e6:.6f} s",
          flush=True)
    job.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m sabench.phases",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    for seed in args.seed:
        one(args.workload, seed)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

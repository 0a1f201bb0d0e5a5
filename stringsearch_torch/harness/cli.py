"""CLI harness: crosscheck | bench | run | queries.

Counterpart of stringsearch_tpu/harness/cli.py, with the same commands,
options and output text, so scripts written against that CLI read this
one's output:

- `crosscheck <file> [len]`: the trusted host oracle and the engine(s)
  each sort the input; every output is verified and the SAs are compared
  byte-exact; nonzero exit on any mismatch. `--trace` also writes diffable
  phase dumps to crosscheck/{engine}.
- `bench <file> [len]`: times each engine and prints a table with Time and
  Average speed in B/s = len / elapsed.
- `run <file> [len]`: one timed sort, "Done in {t}".
- `queries <file> [len]`: batched LCS latency, p50 and p95 per batch size.

Length caps accept k/m/g suffixes.

`crosscheck --engines global` builds the exact global SA
(parallel/global_sa.py) over every device of the platform, rounded down
to a power of two: every visible GPU, or the one CPU device under
`--device cpu`; `--trace` writes crosscheck/global.

What differs: `--device` takes `cpu` or `cuda`. With no `--device` the
commands run on the GPU, and fail with return code 2 when there is none;
they never carry on on the CPU by themselves. The XLA compilation cache
has no counterpart.

    python -m stringsearch_torch.harness.cli crosscheck README.md --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from stringsearch_torch.harness.tracing import Tracer
from stringsearch_torch.utils.sizes import (
    format_size,
    format_throughput,
    parse_size,
)

def resolve_device(device: str | None) -> str | None:
    """The device a harness command runs on: "cpu" when asked for, else
    "cuda". None, with a message, when that needs a GPU and there is none:
    no command carries on on the CPU by itself."""
    if device == "cpu":
        return device
    if not torch.cuda.is_available():
        print("no CUDA device available: pass --device cpu to run the "
              "plain PyTorch versions on the host", file=sys.stderr)
        return None
    return "cuda"


def platform_devices(device: str) -> list:
    """Every device of `device`'s platform: each visible GPU for "cuda",
    the one CPU device for "cpu"."""
    if device == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _load_input(path: str, length: str | None) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if length is not None:
        data = data[:parse_size(length)]
    return data


def _sync(x) -> None:
    """Wait for the device that holds `x`."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _timed_sort(engine_fn, data: bytes, device) -> tuple[float, "object"]:
    t0 = time.perf_counter()
    sa = engine_fn(data, device=device)
    _sync(sa.sa)
    return time.perf_counter() - t0, sa


def command_run(args) -> int:
    from stringsearch_torch.engines import get_engine

    data = _load_input(args.input, args.length)
    engine = get_engine(args.engine)
    # warm-up on a small slice: on a fresh tree this is what builds the
    # kernel libraries, outside the timed sort
    engine(data[: min(len(data), 4096)], device=args.device)
    dt, sa = _timed_sort(engine, data, args.device)
    print(f"Done in {dt:.3f}s ({format_throughput(len(data) / max(dt, 1e-9))})")
    if args.verify:
        sa.verify()
        print("verify: OK")
    return 0


def command_bench(args) -> int:
    from stringsearch_torch.engines import ENGINES, get_engine

    data = _load_input(args.input, args.length)
    print(f"input: {args.input} ({format_size(len(data))})")
    rows = []
    names = args.engines.split(",") if args.engines else list(ENGINES)
    for name in names:
        try:
            engine = get_engine(name)
        except KeyError as e:
            print(f"skipping {name}: {e}", file=sys.stderr)
            continue
        engine(data[: min(len(data), 4096)], device=args.device)  # warm-up
        dt, sa = _timed_sort(engine, data, args.device)
        sa.verify()
        rows.append((name, dt, len(data) / max(dt, 1e-9)))
    w = max(len(r[0]) for r in rows) if rows else 10
    print(f"{'Algorithm':<{w}}  {'Time':>10}  {'Average speed':>16}")
    for name, dt, bps in rows:
        print(f"{name:<{w}}  {dt:>9.3f}s  {format_throughput(bps):>16}")
    return 0


def command_queries(args) -> int:
    """Batched LCS query latency.

    Builds the SA, then times `longest_substring_match_batch` over batches
    of needles sampled from the text (every 8th a guaranteed miss) and
    reports p50/p95 batch latency and needles a second. `--batch` takes a
    comma list (e.g. 64,256,1024) to print the batch-scaling curve in one
    invocation: one SA build, one line per batch size.
    """
    from stringsearch_torch.engines import get_engine

    data = _load_input(args.input, args.length)
    try:
        batches = [int(b) for b in str(args.batch).split(",") if b.strip()]
    except ValueError:
        print(f"error: --batch must be a comma list of ints, got "
              f"{args.batch!r}", file=sys.stderr)
        return 2
    if not batches or any(b < 1 for b in batches):
        print(f"error: --batch needs at least one positive int, got "
              f"{args.batch!r}", file=sys.stderr)
        return 2
    sa = get_engine(args.engine)(data, device=args.device)
    for batch in batches:
        rng = np.random.default_rng(0xBEEF)
        needles = []
        for i in range(batch):
            if i % 8 == 7:  # every 8th needle is a guaranteed miss
                needles.append(
                    bytes(rng.integers(0, 256, 24, dtype=np.uint8)) + b"\xff\xfe"
                )
            else:
                start = int(rng.integers(0, max(1, len(data) - 64)))
                needles.append(data[start : start + int(rng.integers(4, 64))])
        sa.longest_substring_match_batch(needles)  # warm-up
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            sa.longest_substring_match_batch(needles)  # ends in a host fetch
            times.append(time.perf_counter() - t0)
        ts = sorted(times)
        p50 = ts[len(ts) // 2]
        p95 = ts[min(len(ts) - 1, int(len(ts) * 0.95))]
        print(
            f"queries: batch={batch} reps={args.reps} "
            f"p50={p50 * 1e3:.2f}ms p95={p95 * 1e3:.2f}ms "
            f"({batch / p50:,.0f} needles/s)"
        )
    return 0


def command_crosscheck(args) -> int:
    from stringsearch_torch import oracle
    from stringsearch_torch.engines import get_engine

    names = args.engines.split(",") if args.engines else ["doubling"]
    data = _load_input(args.input, args.length)
    print(f"crosscheck on {format_size(len(data))}")

    # the trusted oracle first
    c_sa = oracle.build(data)
    rc = oracle.sufcheck(data, c_sa)
    if rc != 0:
        print(f"FAIL: oracle output failed sufcheck (rc={rc})")
        return 1
    print("oracle: built + sufcheck OK")

    status = 0
    wrote_oracle_trace = False
    for name in names:
        traced = _traced_engine(name) if args.trace else None
        if name == "global":
            sa = _build_global_index(data, args.trace, args.device)
        elif traced is not None:
            with Tracer(f"crosscheck/{name}") as tr:
                sa = traced(data, tr, device=args.device)
        else:
            if args.trace:
                print(
                    f"warning: engine {name!r} has no traced build path; "
                    "running untraced",
                    file=sys.stderr,
                )
            sa = get_engine(name)(data, device=args.device)
        if args.trace and not wrote_oracle_trace:
            with Tracer("crosscheck/oracle") as tr:
                tr.log(f"oracle n={len(data)}")
                tr.dump("SA final", c_sa)
            wrote_oracle_trace = True
        sa.verify()
        got = sa.sa.cpu().numpy()
        if np.array_equal(got, c_sa):
            print(f"{name}: verify OK, byte-exact match vs oracle")
        else:
            bad = int(np.argmax(got != c_sa))
            print(
                f"{name}: MISMATCH at SA[{bad}]: got {got[bad]}, oracle {c_sa[bad]}"
            )
            status = 1
    return status


def _traced_engine(name: str):
    """Traced build entry for `name`, or None (the oracle has none)."""
    if name == "doubling":
        from stringsearch_torch.engines.doubling import sort_traced
    elif name == "dc3":
        from stringsearch_torch.engines.dc3 import sort_traced
    elif name == "bstar":
        from stringsearch_torch.engines.bstar import sort_traced
    else:
        return None
    return sort_traced


def _build_global_index(data: bytes, trace: bool, device: str):
    """Crosscheck entry of the distributed global engine: built over a
    mesh of every device of the platform (rounded down to a power of
    two), as a single-device SuffixArray on the first of them."""
    from stringsearch_torch.parallel.global_sa import build_global
    from stringsearch_torch.parallel.mesh import make_mesh

    devs = platform_devices(device)
    p = len(devs)
    while p & (p - 1):
        p -= 1
    mesh = make_mesh(devices=devs[:p])
    if trace:
        with Tracer("crosscheck/global") as tr:
            g = build_global(data, mesh, tracer=tr)
            tr.dump("SA final", g.suffix_array())
    else:
        g = build_global(data, mesh)
    return g.to_suffix_array_index()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="stringsearch-torch",
        description="suffix-array harness on PyTorch/CUDA "
                    "(crosscheck | bench | run | queries)",
    )
    ap.add_argument("command", choices=["crosscheck", "bench", "run", "queries"])
    ap.add_argument("input", help="input file")
    ap.add_argument("length", nargs="?", default=None, help="size cap (k/m/g suffixes)")
    ap.add_argument(
        "--engine", default="doubling", help="engine for `run` / `queries`"
    )
    ap.add_argument("--engines", default=None, help="comma list for bench/crosscheck")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: cuda, and an error without a GPU")
    ap.add_argument("--verify", action="store_true", help="verify after `run`")
    ap.add_argument("--trace", action="store_true", help="write crosscheck/ trace dumps")
    ap.add_argument("--batch", default="256",
                    help="needle batch for `queries`; comma list for a curve")
    ap.add_argument("--reps", type=int, default=20, help="timing reps for `queries`")
    args = ap.parse_args(argv)

    args.device = resolve_device(args.device)
    if args.device is None:
        return 2

    if args.command == "run":
        return command_run(args)
    if args.command == "bench":
        return command_bench(args)
    if args.command == "queries":
        return command_queries(args)
    return command_crosscheck(args)


if __name__ == "__main__":
    sys.exit(main())

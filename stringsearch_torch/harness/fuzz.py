"""Continuous differential fuzzing of the port.

Counterpart of stringsearch_tpu/harness/fuzz.py. Each iteration generates
adversarial bytes (mutation strategies biased toward SACA-breaking
patterns: runs, repeats, low alphabets, splices), then exercises the
selected targets:

  * engines      sort with each engine, verify on the device, compare
                 byte-exact against the C++ oracle;
  * partitioned  PartitionedSuffixArray queries (2..4 partitions) against
                 the full index: genuine matches, never longer than the
                 optimum, equal to it when an optimal occurrence lies
                 inside one partition; in-partition sa_search counts;
  * transforms   BWT == oracle BWT, unbwt round trips (device and
                 cross-implementation), sa_search/simplesearch parity on
                 sampled and random needles.

`_mutate`, `_length_pool` and `_input_rng` use numpy only and draw
byte-identical inputs to the JAX package's from the same seed, so a seed
or a `crash-<sha1>` found with one package replays on the other.

Failures are shrunk by greedy bisection and written to
fuzz-crashes/crash-<sha1>; commit survivors under tests/corpus/.

`--idx64` also builds every input with the doubling engine at
`idx=torch.int64` and compares it with the oracle. Not ported, and refused
with a message and return code 2: the `global` target (the multi-device
layer). The XLA compilation cache and its environment variables have no
counterpart.

Run: python -m stringsearch_torch.harness.fuzz --iters 200 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

from stringsearch_torch.harness.cli import resolve_device

# always-in-pool adversarial lengths: tiny, power-of-two straddles, and the
# regression corpus's size neighbourhood
_FIXED_LENS = (
    1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
    100, 127, 128, 129, 255, 256, 257, 511, 512, 1000, 1023, 1024,
    2047, 2048,
)

TARGETS = ("engines", "partitioned", "transforms")
GLOBAL_REFUSED = ("the `global` target is not ported: it needs the "
                  "multi-device layer (ROADMAP.md §1, multi-device layer)")


def _length_pool(rng: np.random.Generator, max_len: int, extra: int = 32):
    pool = [n for n in _FIXED_LENS if n <= max_len]
    pool += [int(n) for n in rng.integers(1, max_len + 1, extra)]
    return sorted(set(pool))


def _mutate(rng: np.random.Generator, n: int) -> bytes:
    strategy = int(rng.integers(0, 6))
    if strategy == 0:  # uniform random
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if strategy == 1:  # tiny alphabet
        a = int(rng.choice([1, 2, 3, 4]))
        return bytes(rng.integers(0, a, n, dtype=np.uint8))
    if strategy == 2:  # periodic repeats
        p = int(rng.integers(1, 9))
        unit = bytes(rng.integers(0, 256, p, dtype=np.uint8))
        return (unit * (n // p + 1))[:n]
    if strategy == 3:  # long runs with rare breaks
        arr = np.full(n, int(rng.integers(0, 256)), dtype=np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, n))] = int(rng.integers(0, 256))
        return bytes(arr)
    if strategy == 4:  # splice of two periodic regions
        h = max(n // 2, 1)
        a = _mutate(rng, h)
        b = _mutate(rng, n - h) if n > h else b""
        return (a + b)[:n]
    # near-sorted bytes
    arr = np.sort(rng.integers(0, 256, n, dtype=np.uint8))
    idx = rng.integers(0, n, max(1, n // 10))
    arr[idx] = rng.integers(0, 256, len(idx), dtype=np.uint8)
    return bytes(arr)


def _check_engines(data: bytes, engines, device=None,
                   idx64: bool = False) -> str | None:
    """Differential check against the C++ oracle; with `idx64`, the
    doubling engine's int64 index mode too."""
    import torch

    from stringsearch_torch import oracle
    from stringsearch_torch.core.types import NotSorted
    from stringsearch_torch.engines import get_engine
    from stringsearch_torch.engines.doubling import build_with_isa

    want = oracle.build(data)
    if oracle.sufcheck(data, want) != 0:
        return "oracle output failed sufcheck"
    for name in engines:
        sa = get_engine(name)(data, device=device)
        try:
            sa.verify()
        except NotSorted as e:
            return f"{name}: verify failed: {e}"
        if not np.array_equal(sa.sa.cpu().numpy(), want):
            return f"{name}: mismatch vs oracle"
    if idx64 and len(data) >= 3:
        sa, _isa = build_with_isa(np.frombuffer(data, dtype=np.uint8),
                                  idx=torch.int64, device=device)
        if sa.dtype != torch.int64 or not np.array_equal(sa.cpu().numpy(),
                                                         want):
            return "doubling idx=int64: mismatch vs oracle"
    return None


def _input_rng(data: bytes) -> np.random.Generator:
    """Deterministic RNG derived from the input bytes: the needle draws
    come from here, so a shrunken crash artifact reproduces its failure
    from the file alone."""
    seed = int.from_bytes(hashlib.sha1(data).digest()[:8], "little")
    return np.random.default_rng(seed)


def _check_partitioned(data: bytes, device=None) -> str | None:
    """Partitioned query semantics against the full index.

    A partitioned match may be shorter when every full-text-optimal
    occurrence crosses a partition boundary. The invariant is:
      1. the returned match is genuine (bytes really match, within text);
      2. never longer than the full-index optimum;
      3. equal to the optimum whenever SOME optimal occurrence lies
         entirely inside one partition.
    The needles go through each index as one batch: one fetch each.
    """
    from stringsearch_torch import PartitionedSuffixArray, build_suffix_array

    if len(data) < 4:
        return None
    rng = _input_rng(data)
    full = build_suffix_array(data, device=device)
    nparts = int(rng.choice([2, 3, 4]))
    part = PartitionedSuffixArray(data, nparts, device=device)
    psize = part.partition_size
    needles = []
    for _ in range(4):
        s = int(rng.integers(0, len(data)))
        e = min(len(data), s + int(rng.integers(1, 48)))
        needles.append(data[s:e])
    needles.append(bytes(rng.integers(0, 256, 8, dtype=np.uint8)))
    gots = part.longest_substring_match_batch(needles)
    wants = full.longest_substring_match_batch(needles)
    for nd, got, want in zip(needles, gots, wants):
        if data[got.start : got.start + got.len] != nd[: got.len]:
            return f"partitioned({nparts}) match bytes wrong for {nd[:16]!r}"
        if got.len > want.len:
            return (
                f"partitioned({nparts}) OVERclaims {got.len} > full "
                f"{want.len} for {nd[:16]!r}"
            )
        if got.len < want.len:
            # acceptable only if every optimal occurrence crosses a
            # partition boundary
            best = nd[: want.len]
            s = data.find(best)
            while s != -1:
                if s // psize == (s + want.len - 1) // psize:
                    return (
                        f"partitioned({nparts}) len {got.len} != full "
                        f"{want.len} with an in-partition occurrence at "
                        f"{s} for {nd[:16]!r}"
                    )
                s = data.find(best, s + 1)
    # partitioned sa_search: in-partition count against host brute force
    nd = needles[0][:8]
    if nd:
        want_pos = []
        s = data.find(nd)
        while s != -1:
            if s // psize == (s + len(nd) - 1) // psize:
                want_pos.append(s)
            s = data.find(nd, s + 1)
        count, first = part.sa_search(nd)
        if count != len(want_pos) or (
            want_pos and first != min(want_pos)
        ):
            return (f"partitioned({nparts}) sa_search {count}@{first} vs "
                    f"brute {len(want_pos)}@"
                    f"{min(want_pos) if want_pos else -1} for {nd[:16]!r}")
    return None


def _check_transforms(data: bytes, device=None) -> str | None:
    """BWT/unBWT and search-path differential checks against the oracle:

      * device bwt == oracle bwt (bytes AND primary index);
      * unbwt(bwt(x)) == x (device round trip);
      * unbwt(oracle_bwt) == x (cross-implementation round trip);
      * sa_search / sa_simplesearch == oracle on text-sampled and random
        needles (counts and leftmost SA slots).
    """
    from stringsearch_torch import build_suffix_array, oracle
    from stringsearch_torch.core.search import sa_search_batch, sa_simplesearch
    from stringsearch_torch.transforms.bwt import divbwt, unbwt

    want_u, want_p = oracle.bwt(data)
    got_u, got_p = divbwt(data, device=device)
    if got_u != want_u or got_p != want_p:
        return f"bwt mismatch vs oracle (pidx {got_p} vs {want_p})"
    if unbwt(got_u, got_p, device=device) != data:
        return "unbwt(bwt(x)) != x"
    if unbwt(want_u, want_p, device=device) != data:
        return "unbwt(oracle bwt) != x"
    if len(data) == 0:
        return None
    sa = build_suffix_array(data, device=device)
    osa = oracle.build(data)
    rng = _input_rng(data + b"/search")
    needles = []
    for _ in range(3):
        s = int(rng.integers(0, len(data)))
        e = min(len(data), s + int(rng.integers(1, 32)))
        needles.append(data[s:e])
    needles.append(bytes(rng.integers(0, 256, 6, dtype=np.uint8)))
    for nd, (gc, gl) in zip(needles, sa_search_batch(sa, needles)):
        wc, wl = oracle.search(data, nd, osa)
        if gc != wc or (gc and gl != wl):
            return (f"sa_search mismatch for {nd[:16]!r}: "
                    f"({gc},{gl}) vs ({wc},{wl})")
    for c in (int(data[0]), int(rng.integers(0, 256))):
        wc, wl = oracle.simplesearch(data, c, osa)
        gc, gl = sa_simplesearch(sa, c)
        if gc != wc or (gc and gl != wl):
            return f"simplesearch mismatch for byte {c}"
    return None


def _check(data: bytes, engines, targets, device=None,
           idx64: bool = False) -> str | None:
    """Run every selected target check on `data`.

    Deterministic in `data`: any randomness (the needles) is seeded from
    the input bytes, so crash artifacts replay exactly."""
    if "engines" in targets:
        err = _check_engines(data, engines, device, idx64)
        if err:
            return err
    if "partitioned" in targets:
        err = _check_partitioned(data, device)
        if err:
            return err
    if "transforms" in targets:
        err = _check_transforms(data, device)
        if err:
            return err
    return None


def _shrink(data: bytes, engines, targets, device=None,
            idx64: bool = False) -> bytes:
    """Greedy bisection shrink of a failing input (deterministic)."""
    changed = True
    while changed and len(data) > 1:
        changed = False
        for cut in (len(data) // 2, len(data) // 4, 1):
            if cut == 0:
                continue
            for cand in (data[cut:], data[:-cut]):
                if cand and _check(cand, engines, targets, device,
                                   idx64) is not None:
                    data = cand
                    changed = True
                    break
            if changed:
                break
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stringsearch-torch-fuzz")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--engines", default="doubling")
    ap.add_argument(
        "--targets",
        default="engines",
        help="comma list: engines,partitioned,transforms",
    )
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: cuda, and an error without a GPU")
    ap.add_argument("--out", default="fuzz-crashes")
    ap.add_argument(
        "--replay", default=None, metavar="FILE",
        help="re-run the checks on a crash artifact and exit "
             "(deterministic: needles are derived from the bytes)",
    )
    ap.add_argument("--idx64", action="store_true",
                    help="also build with the doubling engine at "
                         "idx=torch.int64 and compare with the oracle")
    args = ap.parse_args(argv)

    targets = set(args.targets.split(","))
    if "global" in targets:
        print(f"error: {GLOBAL_REFUSED}", file=sys.stderr)
        return 2
    if not targets <= set(TARGETS):
        print(f"error: unknown targets {sorted(targets - set(TARGETS))} "
              f"(have: {', '.join(TARGETS)})", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    if device is None:
        return 2

    seed = args.seed if args.seed is not None else int(time.time())
    rng = np.random.default_rng(seed)
    engines = args.engines.split(",")

    if args.replay is not None:
        with open(args.replay, "rb") as f:
            data = f.read()
        err = _check(data, engines, targets, device, args.idx64)
        print(f"replay {args.replay} ({len(data)}B): "
              f"{err if err else 'no failure'}")
        return 1 if err else 0
    lens = _length_pool(rng, args.max_len)
    print(
        f"fuzzing targets={sorted(targets)} engines={engines} seed={seed} "
        f"iters={args.iters} length-pool={len(lens)}",
        flush=True,
    )

    failures = 0
    for i in range(args.iters):
        n = int(rng.choice(lens))
        data = _mutate(rng, n)
        err = _check(data, engines, targets, device, args.idx64)
        if err is not None:
            failures += 1
            shrunk = _shrink(data, engines, targets, device, args.idx64)
            digest = hashlib.sha1(shrunk).hexdigest()
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, f"crash-{digest}")
            with open(path, "wb") as f:
                f.write(shrunk)
            print(f"[{i}] FAILURE: {err} -> shrunk to {len(shrunk)}B at {path}",
                  flush=True)
        if (i + 1) % 25 == 0:
            print(f"[{i + 1}/{args.iters}] ok so far, {failures} failures",
                  flush=True)
    print(f"done: {args.iters} iterations, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Measured op-cost table, build-phase profiler and radix-partition probe.

Counterpart of stringsearch_tpu/harness/microbench.py, with the same modes
and options:

    python -m stringsearch_torch.harness.microbench ops --n 24
    python -m stringsearch_torch.harness.microbench phases --n 24
    python -m stringsearch_torch.harness.microbench radix --n 28
    python -m stringsearch_torch.harness.microbench walk --n 24

plus `tiedcurve`, `extract`, `bucketed` and `sweep`. Each mode runs on
`--device` (default "cuda"; "cpu" runs the plain PyTorch versions, for a
smoke test only: its times are the host's) and names that device in its
JSON. Every time is the median host wall of `reps` runs after one warm-up,
each ending in `torch.cuda.synchronize()`; the `walk` mode's loops of
2048 launches are timed as a whole (CUDA events on the GPU), one
synchronisation at the end.

How the reference's ops map here: a 1-D `lax.sort` is `device_sort` (the
Hopper radix sort on CUDA), as in the engine; a batched sort along
dimension 1 is a chained stable `torch.sort` along dim 1; `top_k` is
`torch.topk`; a vmapped `dynamic_slice` is a row gather from `unfold`.
Two rows of the reference's op table are sorts the kernel does not take,
seven int32 planes and a float32 key; they run on the plain chained
`torch.sort` (`plain_sort`) under the reference's names with `_plain`
appended: `sort_6key_7op_plain`, `sort_1key_2op_f32_bitcast_plain`.
Not ported:
  * the op table's `sort_1key_2op_i64` row, which exists only under JAX's
    `jax_enable_x64`;
  * the persistent XLA compilation cache, which serves only XLA.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from stringsearch_torch.engines import doubling as D
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import radix
from stringsearch_torch.ops.bitonic import device_sort, plain_sort
from stringsearch_torch.ops.steps import pack_keys

_I32 = torch.int32


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timeit(fn, *args, reps: int = 5) -> float:
    """Median wall time of fn(*args), each run ending in a device sync, in
    seconds; one warm-up run first."""
    fn(*args)
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _text(n: int, device) -> torch.Tensor:
    text = np.frombuffer(enwik_like(n), dtype=np.uint8).copy()
    return torch.from_numpy(text).to(device)


def _row_sort(operands, num_keys: int) -> tuple:
    """Lexicographic sort of 2-D operands along dim 1 by the first
    `num_keys`, stable: the reference's batched `lax.sort(dimension=1)`."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else torch.gather(key, 1, perm)
        order = torch.sort(k, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return tuple(torch.gather(op, 1, perm) for op in operands)


def op_costs(log_n: int, reps: int = 5, device="cuda") -> dict:
    """Cost table for the primitives the engine is built from."""
    n = 1 << log_n

    def rand(seed, high=n):
        return torch.randint(0, high, (n,), dtype=_I32, device=device,
                             generator=_generator(device, seed))

    r32, r32b = rand(0), rand(1)
    j = torch.arange(n, dtype=_I32, device=device)
    perm = torch.randperm(n, device=device,
                          generator=_generator(device, 2)).to(_I32)

    results = {}
    # per-launch latency floor: measured once and subtracted, so the table
    # reports device time, with the floor itself recorded
    tiny = torch.arange(8, dtype=_I32, device=device)
    floor = _timeit(lambda x: x + 1, tiny, reps=max(reps, 5))
    results["dispatch_floor"] = floor

    def add(name, fn, *args):
        results[name] = max(_timeit(fn, *args, reps=reps) - floor, 0.0)

    add("sort_1key_1op", lambda a: device_sort((a,), 1)[0], r32)
    add("sort_1key_2op", lambda a, b: device_sort((a, b), 1), r32, j)
    add("sort_1key_3op",
        lambda a, b, c: device_sort((a, b, c), 1), r32, r32b, j)
    add("sort_2key_3op",
        lambda a, b, c: device_sort((a, b, c), 2), r32, r32b, j)
    add("sort_3key_3op",
        lambda a, b, c: device_sort((a, b, c), 3), r32, r32b, j)
    ks6 = tuple(rand(10 + i) for i in range(6))
    add("sort_4key_5op", lambda *a: device_sort(a, 4), *ks6[:4], j)
    # seven planes: more than the kernel takes
    add("sort_6key_7op_plain", lambda *a: plain_sort(a, 6), *ks6, j)
    # top_k as a stream-compaction candidate (extract the m smallest keys
    # and their positions without a full-width sort)
    add("topk_n64", lambda a: torch.topk(-a, n // 64), r32)
    add("topk_n256", lambda a: torch.topk(-a, n // 256), r32)
    if n >= 16:
        add("topk_n16", lambda a: torch.topk(-a, n // 16), r32)
        add("topk_n4", lambda a: torch.topk(-a, n // 4), r32)
    add("gather", lambda a, p: a[p], r32, perm)
    add("gather_monotone", lambda a, p: a[p], r32, torch.sort(perm).values)
    add("gather_table256", lambda t, i: t[i],
        torch.arange(256, dtype=_I32, device=device), r32 & 255)
    # row-slice gather: rows of `unfold` picked by start. Row width shrinks
    # with n so the probe stays valid for tiny --n
    row_w = min(4096, n)
    nrows = max(n // row_w, 1)
    starts = torch.randint(0, max(n - row_w, 1), (nrows,), device=device,
                           generator=_generator(device, 5))
    add(f"slice_gather_rows{row_w}", lambda a, s: a.unfold(0, row_w, 1)[s],
        r32, starts)
    # batched (segmented) sorts along rows of 4096
    if n >= (1 << 16):
        b = n // 4096
        a2 = r32.reshape(b, 4096)
        p2 = torch.arange(4096, dtype=_I32, device=device).expand(b, 4096)
        add("batched_sort_1key_2op_rows4096",
            lambda a, p: _row_sort((a, p), 1), a2, p2)
        add("batched_sort_5key_6op_rows4096",
            lambda *a: _row_sort(a, 5), *(k.reshape(b, 4096) for k in ks6[:5]),
            p2)

    def scatter_set(a, p):
        out = torch.zeros_like(a)
        out[p] = a
        return out

    add("scatter_set", scatter_set, r32, perm)
    add("scatter_via_sort", lambda p, v: device_sort((p, v), 1)[1], perm, r32)
    add("cummax", lambda a: torch.cummax(a, 0).values, r32)
    add("cumsum", lambda a: torch.cumsum(a, 0, dtype=_I32), r32)
    add("shift_concat_slice",
        lambda a: torch.cat([a, torch.full_like(a, -1)])[8:8 + n], r32)
    add("elementwise_3in",
        lambda a, b, c: torch.where(a > b, c, a + b), r32, r32b, j)
    # a float32 key (the bits of r32): the kernel takes int32 planes only
    add("sort_1key_2op_f32_bitcast_plain",
        lambda a, b: plain_sort((a, b), 1), r32.view(torch.float32), j)
    return results


def phase_profile(log_n: int, reps: int = 3, depth: int = 12, fan: int = 4,
                  device="cuda") -> dict:
    """Per-phase timing and round counts of the lazy-invert build on enwik
    text: the initial sorted-order sort, the inverse permutation each round
    pays for its predecessor, and the fan round's sort, plus the compaction
    tail when anything stays tied. The compaction rounds update the [n+1]
    rank and SA buffers in place, so each timed run works on copies of them
    and its time includes those two copies."""
    n = 1 << log_n
    text = _text(n, device)
    out = {"n": n, "depth": depth, "fan": fan, "device": _device_name(device)}
    out["t_initial_sorted"] = _timeit(
        lambda t: D._initial_sorted(t, depth), text, reps=reps)
    sa_s, rank_s, count = D._initial_sorted(text, depth)
    out["t_invert"] = _timeit(D._scatter_to_text_order, sa_s, rank_s,
                              reps=reps)
    rank = D._scatter_to_text_order(sa_s, rank_s)
    counts = [int(count)]
    t_full = []
    h = depth
    threshold = n // 4
    while counts[-1] > threshold and h < n:
        t_full.append(_timeit(lambda r: D._full_round_sorted(r, h, fan),
                              rank, reps=reps))
        sa_s, rank_s, count = D._full_round_sorted(rank, h, fan)
        counts.append(int(count))
        h = min(h * fan, n)
        if counts[-1] > threshold:
            rank = D._scatter_to_text_order(sa_s, rank_s)
    out["full_rounds"] = len(t_full)
    out["t_full_sorted_each"] = [round(t, 4) for t in t_full]
    out["tied_counts"] = counts
    if counts[-1] == 0:
        out["note"] = ("resolved in the full rounds: the fused build_sa "
                       "skips every phase below this line")
        out["t_total_fused"] = _timeit(
            lambda t: D.build_sa(t, depth=depth, fan=fan), text, reps=reps)
        out["bytes_per_s_fused"] = round(n / out["t_total_fused"], 1)
        return out
    rank = D._scatter_to_text_order(sa_s, rank_s)
    m1 = max(n // 4, 1)
    m2 = min(n, max(n // 64, 64), m1)
    out["t_extract_l1"] = _timeit(D._extract, rank_s, sa_s, m1, reps=reps)
    g, pos = D._extract(rank_s, sa_s, m1)
    rank_buf = torch.cat([rank, rank.new_zeros((1,))])
    sa_buf = torch.cat([sa_s, sa_s.new_zeros((1,))])

    def timed_round(g, pos, h):
        return _timeit(lambda: D._compact_round(
            g, pos, rank_buf.clone(), sa_buf.clone(), h), reps=reps)

    t_comp = []
    comp_counts = []
    while int(count) > m2 and h < n:
        t_comp.append(timed_round(g, pos, h))
        g, pos, _, _, count = D._compact_round(g, pos, rank_buf, sa_buf, h)
        comp_counts.append(int(count))
        h *= 2
    out["l1_rounds"] = len(t_comp)
    out["t_l1_each"] = [round(t, 4) for t in t_comp]
    out["t_shrink_l2"] = _timeit(D._shrink, g, pos, m2, reps=reps)
    g, pos = D._shrink(g, pos, m2)
    t2 = []
    while int(count) > 0 and h < n:
        t2.append(timed_round(g, pos, h))
        g, pos, _, _, count = D._compact_round(g, pos, rank_buf, sa_buf, h)
        comp_counts.append(int(count))
        h *= 2
    out["l2_rounds"] = len(t2)
    out["t_l2_each"] = [round(t, 4) for t in t2]
    out["compact_tied_counts"] = comp_counts
    out["t_total_fused"] = _timeit(
        lambda t: D.build_sa(t, depth=depth, fan=fan), text, reps=reps)
    out["bytes_per_s_fused"] = round(n / out["t_total_fused"], 1)
    return out


def tied_curve(log_n: int, depth: int = 12, fan: int = 2, reps: int = 2,
               device="cuda") -> dict:
    """Tied-position counts against resolved key depth on enwik-like text:
    full rounds are worth their price until the tied count fits a
    compaction level."""
    n = 1 << log_n
    text = _text(n, device)
    out = {"n": n, "depth": depth, "fan": fan, "device": _device_name(device),
           "rounds": []}
    t0 = _timeit(lambda t: D._initial_full(t, depth), text, reps=reps)
    rank, _sa, _rs, count = D._initial_full(text, depth)
    out["t_initial"] = round(t0, 4)
    out["rounds"].append({"h": depth, "tied": int(count),
                          "frac": round(int(count) / n, 4)})
    h = depth
    while int(count) > n // 4096 and h < n:
        t = _timeit(lambda r: D._full_round(r, h, fan), rank, reps=reps)
        rank, _sa, _rs, count = D._full_round(rank, h, fan)
        h = min(h * fan, n)
        out["rounds"].append({"h": h, "tied": int(count),
                              "frac": round(int(count) / n, 4),
                              "t_round": round(t, 4)})
    return out


def extract_variants(log_n: int, depth: int = 12, fan: int = 4,
                     reps: int = 3, device="cuda") -> dict:
    """Cost of tied-group extraction: full-width sort against `torch.topk`
    at several capacities, on the real post-full-round state."""
    n = 1 << log_n
    text = _text(n, device)
    rank, sa_s, rank_s, count = D._initial_full(text, depth)
    if int(count) > n // 4:
        rank, sa_s, rank_s, count = D._full_round(rank, depth, fan)
    out = {"n": n, "tied": int(count), "device": _device_name(device)}
    for div in (4, 16, 64):
        m = n // div
        if m < int(count):
            continue
        for method in ("sort", "topk"):
            t = _timeit(lambda rs, ss: D._extract(rs, ss, m, method),
                        rank_s, sa_s, reps=reps)
            out[f"{method}_m_n{div}"] = round(t, 4)
    return out


def bucketed_initial(log_n: int, reps: int = 3, device="cuda") -> dict:
    """Can a leading-key grouping sort plus batched per-row sorts beat one
    flat multi-key sort for the initial ranking?

      flat:        device_sort((w0, w1, w2, j), 3), the depth-12 initial;
      carry_rows:  device_sort((w0, w1, w2, j), 1), then a per-row 3-key
                   sort of the [rows, n/rows] reshape. Rows are position
                   blocks of the w0-sorted order, so w0-groups spanning row
                   boundaries still need a repair pass that this probe does
                   not pay for: its number is a lower bound;
      gather_rows: a 2-operand grouping sort, gathers of w1/w2 into the
                   grouped order, and the same per-row sort.
    """
    n = 1 << log_n
    text = _text(n, device)
    w0, w1, w2, j = pack_keys(text, 12)
    rows = 4096
    cols = n // rows
    out = {"n": n, "rows": rows, "device": _device_name(device)}

    def flat(w0, w1, w2, j):
        return device_sort((w0, w1, w2, j), 3)

    def carry_rows(w0, w1, w2, j):
        s = device_sort((w0, w1, w2, j), 1)
        return _row_sort(tuple(x.reshape(rows, cols) for x in s), 3)

    def gather_rows(w0, w1, w2, j):
        s0, sj = device_sort((w0, j), 1)
        g = (s0, w1[sj], w2[sj], sj)
        return _row_sort(tuple(x.reshape(rows, cols) for x in g), 3)

    for name, fn in (("flat_3key", flat), ("carry_rows", carry_rows),
                     ("gather_rows", gather_rows)):
        out[name] = round(_timeit(fn, w0, w1, w2, j, reps=reps), 4)
    return out


def radix_probe(log_n: int, reps: int = 3, device="cuda") -> dict:
    """Radix-partition stage costs against the port's sort (ops/radix.py).

      t_sort_1key_2op — the (key, payload) sort of n pairs by `device_sort`
                  (the Hopper radix sort on CUDA); the plain chained
                  `torch.sort` beside it as t_sort_1key_2op_plain;
      checks    — the `check_*` functions of ops/radix.py on the device;
      t_hist    — per-tile 256-bin histograms (tile 8192);
      t_group   — stable in-tile grouping at tile T;
      t_flush   — granule-G scatter of n values to random / sequential
                  granule destinations;
      pass8_est(T, G) — a composed 8-bit partition pass: hist + group_T +
                  2 x flush_G scaled by the granule-quantized volume (keys
                  and payloads, ceil(T/256/G) granules per (tile, bin)
                  segment), with that pad factor.
    Keys are random 32-bit patterns as int32, the payload `arange(n)`.
    Times are not rounded (the reference rounds to 0.1 ms, which would
    zero the sub-millisecond stages of a GPU).
    """
    n = 1 << log_n
    keys = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=_I32,
                         device=device, generator=_generator(device, 0))
    pay = torch.arange(n, dtype=_I32, device=device)
    out = {"n": n, "device": _device_name(device)}

    out["t_sort_1key_2op"] = _timeit(
        lambda a, b: device_sort((a, b), 1), keys, pay, reps=reps)
    out["t_sort_1key_2op_plain"] = _timeit(
        lambda a, b: plain_sort((a, b), 1), keys, pay, reps=reps)

    # correctness gates on the device before timing (small slices)
    hk, hp = keys[:8 * 8192], pay[:8 * 8192]
    out["checks"] = {
        "hist": radix.check_histogram(hk, tile=8192),
        "group": radix.check_local_group(hk[:8 * 1024], hp[:8 * 1024],
                                         tile=1024),
        "flush": radix.check_granule_flush(device=device),
    }

    out["t_hist"] = _timeit(
        lambda k: radix.block_histograms(k, tile=8192), keys, reps=reps)

    group_t = {}
    for tile in (1024, 2048):
        group_t[tile] = _timeit(
            lambda k, p, t=tile: radix.local_group(k, p, tile=t),
            keys, pay, reps=reps)
    out["t_group"] = group_t

    flush_t = {}
    for granule in (128, 1024, 4096):
        rows = n // granule
        # the reference's descriptor blocking: 2^14 rows, or fewer where
        # that does not divide the row count
        per_block = math.gcd(rows, 1 << 14)
        rng = np.random.default_rng(1)
        desc_rand = torch.from_numpy(
            rng.permutation(rows).astype(np.int32)).to(device)
        desc_seq = torch.arange(rows, dtype=_I32, device=device)
        src = pay.reshape(rows, granule)

        def flush(d, s, g=granule, pb=per_block, r=rows):
            return radix.granule_flush(d, s, g, pb, r)

        t_r = _timeit(flush, desc_rand, src, reps=reps)
        t_s = _timeit(flush, desc_seq, src, reps=reps)
        flush_t[granule] = {
            "rand_s": t_r, "seq_s": t_s, "rand_gb_per_s": n * 4 / t_r / 1e9,
            "per_block": per_block,
        }
    out["t_flush"] = flush_t

    # composition: best-case assembled 8-bit pass
    est = {}
    for tile, tg in group_t.items():
        for granule, tf in flush_t.items():
            nblocks = n // tile
            granules_real = nblocks * 256 * (-(-tile // (256 * granule)))
            volume_factor = granules_real * granule / n
            t_pass = out["t_hist"] + tg + 2 * tf["rand_s"] * volume_factor
            est[f"T{tile}_G{granule}"] = {
                "t_pass_est": t_pass,
                "pad_factor": volume_factor,
                "vs_sort": t_pass / out["t_sort_1key_2op"],
                "vs_plain_sort": t_pass / out["t_sort_1key_2op_plain"],
            }
    out["pass8_est"] = est
    return out


def _loop_seconds(fn, device, reps: int) -> float:
    """Median time of fn(), a loop of many launches, after one warm-up:
    CUDA events around the whole loop on the GPU, the host clock
    elsewhere; one synchronisation at the end either way."""
    if torch.device(device).type != "cuda":
        return _timeit(fn, reps=reps)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(np.median(times))


def walk_probe(log_n: int, reps: int = 3, device="cuda") -> dict:
    """Blocked-cycle-walk feasibility probe for the inverse BWT.

    The shipped unbwt is pointer jumping: bit_length(n) rounds of one
    full-width row gather (transforms/bwt.py). The alternative is B
    lockstep walkers doing about n/B TINY (B-index) gathers: phase 1 walks
    marker to marker to stitch orbit offsets, phase 2 walks again emitting
    bytes with a B-index scatter a step. Whether that wins is decided by
    the cost of one step, measured here over 2048 steps.

    A step is one launch (two with the scatter) from a host loop, the
    whole loop timed at once: PyTorch has no compiled loop to put the
    steps in, so `us_per_step_*` is the cost of a launch as much as of a
    B-index gather, by construction.

    Reports microseconds a step and the extrapolated two-phase unbwt
    estimate at the expected longest interval, about (n/B)(ln B + 2)
    lockstep steps (random marker spacing on the cycle), beside the cost
    of pointer jumping (`t_pointer_jumping`, the whole `_unbwt_kernel` on
    random bytes) and of one of its rounds alone in three formulations
    (`t_jump_round`).
    """
    from stringsearch_torch.transforms.bwt import _jump, _unbwt_kernel

    n = 1 << log_n
    perm = torch.randperm(n, device=device,
                          generator=_generator(device, 0)).to(_I32)
    steps = 2048
    out = {"n": n, "steps_measured": steps, "device": _device_name(device)}

    results = {}
    for b in (1024, 4096, 16384):
        start = torch.randint(0, n, (b,), dtype=_I32, device=device,
                              generator=_generator(device, b))

        def walk_g():
            cur = start
            for _ in range(steps):
                cur = perm[cur]
            return cur

        def walk_gs():
            cur = start
            acc = torch.zeros((n,), dtype=_I32, device=device)
            for t in range(steps):
                acc[cur] = t
                cur = perm[cur]
            return cur, acc

        per_g = _loop_seconds(walk_g, device, reps) / steps * 1e6
        per_gs = _loop_seconds(walk_gs, device, reps) / steps * 1e6
        # two-phase estimate: lockstep to the expected longest interval
        # between markers; phase 1 gathers only, phase 2 gathers and
        # scatters
        maxlen = (n / b) * (math.log(b) + 2)
        results[b] = {
            "us_per_step_gather": per_g,
            "us_per_step_gather_scatter": per_gs,
            "est_two_phase_s": maxlen * (per_g + per_gs) / 1e6,
        }
    out["walkers"] = results

    # the incumbent at this size, for the same table
    u = torch.randint(0, 256, (n,), dtype=torch.uint8, device=device,
                      generator=_generator(device, 9))
    rounds = max(1, n.bit_length())
    out["rounds"] = rounds
    out["t_pointer_jumping"] = _timeit(
        lambda a: _unbwt_kernel(a, 0, rounds), u, reps=reps)
    # one round alone, on a state whose pointers are a random permutation
    state = torch.stack([
        torch.cat([perm, perm.new_zeros((1,))]),
        torch.ones((n + 1,), dtype=_I32, device=device)], 1)
    nxt, dist = state[:, 0].contiguous(), state[:, 1].contiguous()

    def advanced_index(st):
        g = st[st[:, 0]]
        return torch.stack([g[:, 0], st[:, 1] + g[:, 1]], 1)

    # the round as shipped (one 8-byte `index_select` by an int32 index),
    # as the reference writes it (a row gather by advanced indexing), and
    # as two planes (two 4-byte gathers)
    out["t_jump_round"] = {
        "row8_index_select_int32": _timeit(_jump, state, reps=reps),
        "rows_advanced_index": _timeit(advanced_index, state, reps=reps),
        "two_planes": _timeit(lambda a, d: (a[a], d + d[a]), nxt, dist,
                              reps=reps),
    }
    return out


def config_sweep(log_n: int, reps: int = 2, configs=None,
                 device="cuda") -> dict:
    """End-to-end build wall time across configurations.

    `fn`: "sa" = build_sa (the headline path, no ISA), "isa" =
    build_with_isa."""
    n = 1 << log_n
    text = _text(n, device)
    if configs is None:
        configs = [
            dict(fn="isa", depth=12, fan=4),
            dict(fn="sa", depth=12, fan=4),
            dict(fn="sa", depth=12, fan=2),
            dict(fn="sa", depth=16, fan=2),
            dict(fn="sa", depth=16, fan=4),
        ]
    out = {"n": n, "device": _device_name(device), "configs": []}
    for cfg in configs:
        cfg = dict(cfg)
        if cfg.pop("fn", "sa") == "sa":
            fn, run = D.build_sa, (lambda x: D.build_sa(x, **cfg))
        else:
            fn = D.build_with_isa
            run = lambda x: D.build_with_isa(x, **cfg)[0]  # noqa: E731
        try:
            t = _timeit(run, text, reps=reps)
        except torch.cuda.OutOfMemoryError as e:  # deep initials may not fit
            torch.cuda.empty_cache()
            rec = {**{k: str(v) for k, v in cfg.items()},
                   "fn": fn.__name__, "error": repr(e)[:160]}
            out["configs"].append(rec)
            print(json.dumps(rec), flush=True)
            continue
        rec = {**{k: str(v) for k, v in cfg.items()}, "fn": fn.__name__,
               "wall_s": round(t, 4), "mb_per_s": round(n / t / 1e6, 2)}
        out["configs"].append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="microbench")
    p.add_argument("mode", choices=["ops", "phases", "tiedcurve",
                                    "extract", "bucketed", "sweep",
                                    "radix", "walk"])
    p.add_argument("--n", type=int, default=24, help="log2 of element count")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--depth", type=int, default=None,
                   help="initial key bytes (default: each mode's own "
                        "default, 12, the headline config)")
    p.add_argument("--fan", type=int, default=2)
    p.add_argument("--configs", default=None,
                   help="JSON list of sweep configs, e.g. "
                        '[{"fn":"sa","depth":12,"fan":4}]')
    p.add_argument("--device", default="cuda",
                   help='torch device (default "cuda"; "cpu" for a smoke run)')
    args = p.parse_args(argv)
    dev = args.device
    dkw = {} if args.depth is None else {"depth": args.depth}
    fan = max(args.fan, 2)
    if args.mode == "ops":
        res = op_costs(args.n, args.reps, dev)
        for k, v in res.items():
            print(f"{k:32s} {v * 1e3:10.3f} ms")
        print(json.dumps({"log_n": args.n, "device": _device_name(dev),
                          **{k: round(v, 5) for k, v in res.items()}}))
    elif args.mode == "phases":
        print(json.dumps(phase_profile(args.n, args.reps, fan=fan,
                                       device=dev, **dkw)))
    elif args.mode == "tiedcurve":
        print(json.dumps(tied_curve(args.n, fan=fan, reps=args.reps,
                                    device=dev, **dkw)))
    elif args.mode == "extract":
        print(json.dumps(extract_variants(args.n, fan=fan, reps=args.reps,
                                          device=dev, **dkw)))
    elif args.mode == "bucketed":
        print(json.dumps(bucketed_initial(args.n, args.reps, dev)))
    elif args.mode == "radix":
        print(json.dumps(radix_probe(args.n, args.reps, dev)))
    elif args.mode == "walk":
        print(json.dumps(walk_probe(args.n, args.reps, dev)))
    elif args.mode == "sweep":
        cfgs = None
        if args.configs:
            cfgs = [
                {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in c.items()}
                for c in json.loads(args.configs)
            ]
        print(json.dumps(config_sweep(args.n, args.reps, cfgs, dev)))


if __name__ == "__main__":
    main()

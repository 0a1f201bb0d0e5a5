"""Where the time of one suffix-array build goes, on one GPU.

    python -m stringsearch_torch.harness.profile_build

At n = 2^24 and 2^28 bytes of enwik-like text it builds the suffix array
with every sort on the Hopper bitonic kernel, then with the plain chained
`torch.sort` in the kernel's place, and prints for each:
  * the host wall of three builds after a warm-up one (each ends in
    `torch.cuda.synchronize()`), and the peak CUDA memory of a build;
  * the CUDA-event time of every `device_sort` call of one build, with its
    plane and key counts, and the build's device time outside the sorts;
  * from `torch.profiler` over one more build: the device time of each
    kernel, summed by name, and the device's idle share, 1 - summed kernel
    time / median unprofiled wall.
Needs a CUDA device.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

import stringsearch_torch as st
from stringsearch_torch.engines import doubling
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import bitonic

SIZES = (24, 28)


def _timed(sort, log):
    """`sort`, recording CUDA events around each call into `log`."""
    def timed_sort(operands, num_keys=1):
        operands = tuple(operands)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sort(operands, num_keys)
        end.record()
        log.append((len(operands), num_keys, start, end))
        return out
    return timed_sort


def _one_build(text):
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    return sa


def _short(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    return re.sub(r"\((?!\().*$", "", name).strip()[:72]


def profile(text, sort, label: str) -> None:
    n = text.shape[0]
    doubling.device_sort = sort
    try:
        _one_build(text)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            _one_build(text)
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        wall = statistics.median(walls)
        print(f"2^{n.bit_length() - 1} {label}: build wall "
              f"{', '.join(f'{w:.4f}' for w in walls)} s (median {wall:.4f} s, "
              f"{n / wall:.1f} B/s), peak CUDA memory {peak} B", flush=True)

        log = []
        doubling.device_sort = _timed(sort, log)
        _one_build(text)
        sorts = 0.0
        for c, nk, start, end in log:
            ms = start.elapsed_time(end)
            sorts += ms
            print(f"   sort C={c} keys={nk}: {ms:.3f} ms")
        doubling.device_sort = sort

        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            _one_build(text)
        per = defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                per[_short(e.name)][0] += e.time_range.elapsed_us() / 1e3
                per[_short(e.name)][1] += 1
        busy = sum(ms for ms, _ in per.values())
        if not per:
            print("   profiler: no device events recorded (idle share not "
                  "measured)")
            return
        print(f"   sorts {sorts:.3f} ms; device time outside the sorts "
              f"{busy - sorts:.3f} ms")
        print(f"   profiler: summed kernel time {busy:.3f} ms of wall "
              f"{wall * 1e3:.3f} ms, idle share {1 - busy / (wall * 1e3):.4f}")
        for name, (ms, count) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            if ms >= 0.01 * busy:
                print(f"   {ms:10.3f} ms x {count:3d}  {name}")
    finally:
        doubling.device_sort = bitonic.device_sort


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bitonic.load_library()
    for log2n in SIZES:
        text = torch.from_numpy(
            np.frombuffer(enwik_like(1 << log2n), dtype=np.uint8).copy()
        ).to("cuda")
        profile(text, bitonic.device_sort, "kernel")
        profile(text, bitonic.plain_sort, "plain")
        del text
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

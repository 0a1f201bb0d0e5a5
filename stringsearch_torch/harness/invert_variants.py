"""What each design of the invert kernel buys, on one GPU.

    python -m stringsearch_torch.harness.invert_variants [SIZE ...]

SIZE is log2 of the text's bytes, or `e9` for 10^9 (default: 28 e9).
For each size, two texts (`harness/corpus.py:enwik_like` and the
Fibonacci word) are built as `sort()` builds them, with every invert
(`engines/doubling.py:_scatter_to_text_order`) intercepted: on that
invert's own (sa_s, rank_s), each copy of `ops/csrc/steps.cu` in VARIANTS
(a text replacement that must match its source exactly once) is held
against the as-built kernel (tolerance 0) and timed, beside the C=2 radix
sort of (sa_s, rank_s) that the invert was before (`device_sort`), and
then the same on a random permutation of the size. The copies are
written to and built in `stringsearch_torch/_build/variants/`.

Each time is the mean of CUDA events over five calls after a warm one,
beside the bytes bound at 3.35 TB/s: sa_s and rank_s read once, the ranks
written once (12 n bytes in int32). Prints one JSON line a text. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from stringsearch_torch.engines import doubling
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import _build, steps
from stringsearch_torch.ops.bitonic import device_sort

BYTES_PER_S = 3.35e12
_DIRECT = "constexpr int64_t kDirectBytes = int64_t(32) << 20;"
_WINDOW = "constexpr int64_t kWindowBytes = int64_t(8) << 20;"
_PLACE = "constexpr int kPlaceBytes = 64 * 1024;"
VARIANTS = {
    "as built": (),
    "one store an element": ((_DIRECT, _DIRECT.replace("<< 20", "<< 50")),),
    "windows of 4 MB": ((_WINDOW, _WINDOW.replace("8) << 20", "4) << 20")),),
    "windows of 16 MB": ((_WINDOW,
                          _WINDOW.replace("8) << 20", "16) << 20")),),
    "places of 32 KB": ((_PLACE, _PLACE.replace("64 *", "32 *")),),
}


def variant_source(name: str) -> str:
    """Write the copy of the source with VARIANTS[name]; returns its path."""
    with open(steps._SOURCE) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} does not occur "
                               f"exactly once in {steps._SOURCE}")
        src = src.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, "variants",
                        "steps_" + name.replace(" ", "_") + ".cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def variant_library(name: str):
    """The steps library built from variant `name`'s source."""
    return steps._load(_build.build_library(
        "steps_variant", [variant_source(name)],
        [_build.nvcc(), *_build.NVCC_FLAGS]))


def invert_with(lib, sa_s, rank_s):
    """`steps.invert_ranks` on the library `lib`."""
    n = sa_s.shape[0]
    width = rank_s.element_size()
    rank = torch.empty_like(rank_s)
    nbytes = lib.ss_invert_ranks_scratch_bytes(n, width)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=sa_s.device)
               if nbytes else None)
    rc = lib.ss_invert_ranks(sa_s.data_ptr(), rank_s.data_ptr(), n, width,
                             rank.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ss_invert_ranks failed (code {rc})")
    return rank


def _ms(fn, reps: int = 5) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(libs, sa_s, rank_s) -> dict:
    """Each design's ms on one invert's operands, held against the as-built
    kernel, and the sort's."""
    want = steps.invert_ranks(sa_s, rank_s)
    out = {}
    for name, lib in libs.items():
        got = invert_with(lib, sa_s, rank_s)
        if not torch.equal(got, want):
            raise RuntimeError(f"variant {name!r} disagrees with the kernel")
        del got
        out[name] = _ms(lambda lib=lib: invert_with(lib, sa_s, rank_s))
    out["C=2 radix sort"] = _ms(
        lambda: device_sort((sa_s, rank_s), num_keys=1))
    if not torch.equal(device_sort((sa_s, rank_s), num_keys=1)[1], want):
        raise RuntimeError("the kernel disagrees with the sort")
    return out


def fibonacci(n: int) -> np.ndarray:
    a, b = np.array([97], np.uint8), np.array([97, 98], np.uint8)
    while b.size < n:
        a, b = b, np.concatenate([b, a])
    return b[:n]


def texts(size: str):
    n = 10 ** 9 if size == "e9" else 1 << int(size)
    yield "enwik_like", n, lambda: np.frombuffer(enwik_like(n), np.uint8)
    yield "fibonacci", n, lambda: fibonacci(n)


def run(size: str, libs, card: str) -> None:
    lines = []
    for name, n, make in texts(size):
        text = torch.from_numpy(make().copy()).to("cuda")
        inverts = []
        plain = doubling._scatter_to_text_order

        def hooked(sa_s, rank_s, out=None):
            inverts.append(measure(libs, sa_s, rank_s))
            return plain(sa_s, rank_s, out)

        doubling._scatter_to_text_order = hooked
        try:
            doubling.sort(text)
        finally:
            doubling._scatter_to_text_order = plain
        del text
        torch.cuda.empty_cache()
        lines.append({"text": name, "n": n, "inverts": len(inverts),
                      "ms_a_build": {k: round(sum(i[k] for i in inverts), 4)
                                     for k in inverts[0]} if inverts else {},
                      "ms_each": [{k: round(v, 4) for k, v in i.items()}
                                  for i in inverts]})
    perm = torch.randperm(lines[0]["n"], device="cuda", dtype=torch.int32)
    ranks = torch.randint(0, 1 << 30, perm.shape, device="cuda",
                          dtype=torch.int32)
    one = measure(libs, perm, ranks)
    lines.append({"text": "random permutation", "n": perm.shape[0],
                  "inverts": 1, "ms_a_build": {k: round(v, 4)
                                               for k, v in one.items()}})
    del perm, ranks
    torch.cuda.empty_cache()
    for line in lines:
        line["bound_ms"] = round(12 * line["n"] / BYTES_PER_S * 1e3, 4)
        line["card"] = card
        print(json.dumps(line), flush=True)


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        sys.exit("invert_variants needs a CUDA device")
    sizes = (argv if argv is not None else sys.argv[1:]) or ["28", "e9"]
    card = torch.cuda.get_device_name(0)
    libs = {name: variant_library(name) for name in VARIANTS}
    for size in sizes:
        run(size, libs, card)


if __name__ == "__main__":
    main()

"""What each design choice of the two sort kernels buys, on one GPU.

    python -m stringsearch_torch.harness.sort_variants

Builds copies of `ops/csrc/radix_sort.cu` (the sort behind `device_sort`)
and of `ops/csrc/bitonic.cu` with one choice changed (the text replacements
in RADIX_VARIANTS and VARIANTS, each of which must match its source exactly
once), checks every copy against the plain sort (the radix copies on every
plane, the unstable bitonic copies on their keys), and times each with CUDA
events at the main path's plane counts, at n = 2^24 and 2^28: random int32
keys plus a position plane. A bitonic time includes the copy of the input
planes, as `bitonic_sort` makes one; a radix time includes the allocation
of its two scratch sets, as `radix_sort` makes them. The variants run in
order, then in reverse order, so a drift of the card's clock shows as a gap
between the two times of one variant. The copies are written to and built
in `stringsearch_torch/_build/variants/`. Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess

import torch

from stringsearch_torch.ops import _build, bitonic, radix_sort

_DEVICE_STAGES = "constexpr int kGlobalGroupStages = 3;"
_TILE_STAGES = "constexpr int kTileGroupStages = 2;"
_SHARED_INDEX = "return s[q * tile + i];"

# bitonic.cu
VARIANTS = {
    "as built": (),
    "device stages 2": ((_DEVICE_STAGES, _DEVICE_STAGES.replace("3", "2")),),
    "device stages 1": ((_DEVICE_STAGES, _DEVICE_STAGES.replace("3", "1")),),
    "tile stages 1": ((_TILE_STAGES, _TILE_STAGES.replace("2", "1")),),
    # XOR of bits 2..6 into bits 0..4 of the shared-memory index
    "swizzle": ((_SHARED_INDEX,
                 "return s[q * tile + (i ^ ((i >> 2) & 31))];"),),
}

_TILE = "constexpr int kTile = 16384;"
_THREADS = "constexpr int kThreads = 512;"
# first statement of `lanes_of_digit`; a return in its line leaves the eight
# ballots unreached
_BALLOTS = "  unsigned peers = __ballot_sync(kFull, live);\n"
_MATCH_ANY = ("  return __match_any_sync(kFull, live ? b : kBins); "
              "unsigned peers = 0;\n")
_BLOCKS = "constexpr int kScatterBlocks = 512 / kThreads;"


def _radix(tile=None, threads=None, resident=None, match_any=False) -> tuple:
    """Edits of radix_sort.cu: the tile (keys per block; a thread ranks
    tile / threads of them), the block, the resident threads per SM that
    cap the scatter kernel's registers, and how the lanes of one digit find
    each other."""
    edits = []
    if tile:
        edits.append((_TILE, _TILE.replace("16384", str(tile))))
    if threads:
        edits.append((_THREADS, _THREADS.replace("512", str(threads))))
    if resident:
        edits.append((_BLOCKS, _BLOCKS.replace("512", str(resident))))
    if match_any:
        edits.append((_BALLOTS, _MATCH_ANY))
    return tuple(edits)


RADIX_VARIANTS = {
    "radix as built": (),
    "radix match_any": _radix(match_any=True),
    "radix tile 16384 threads 1024": _radix(threads=1024, resident=1024),
    "radix tile 32768 threads 1024": _radix(tile=32768, threads=1024,
                                            resident=1024),
    "radix tile 8192 threads 256": _radix(tile=8192, threads=256),
    "radix tile 8192 threads 256 one block": _radix(tile=8192, threads=256,
                                                    resident=256),
    "radix tile 8192 threads 512": _radix(tile=8192, resident=1024),
    "radix tile 4096 threads 256": _radix(tile=4096, threads=256),
    "radix tile 4096 threads 256 four blocks": _radix(
        tile=4096, threads=256, resident=1024),
}
SHAPES = ((2, 1), (4, 3), (5, 4))  # (planes, keys): invert, initial, round
SIZES = (24, 28)


def variant_source(name: str) -> str:
    """Write the patched copy of variant `name`'s source; returns its path."""
    if name in RADIX_VARIANTS:
        source, edits = radix_sort._SOURCE, RADIX_VARIANTS[name]
    else:
        source, edits = bitonic._SOURCE, VARIANTS[name]
    with open(source) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} does not occur "
                               f"exactly once in {source}")
        src = src.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, "variants",
                        name.replace(" ", "_") + ".cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def _bitonic_sorted(lib, planes, nk):
    out = tuple(p.clone() for p in planes)
    bitonic.launch_sort(lib, out, nk)
    return out


def _ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    # name -> (sort of planes by their first nk, planes compared exactly)
    sorts = {}
    for name in RADIX_VARIANTS:
        lib = radix_sort.build(name.replace(" ", "_"), variant_source(name))
        sorts[name] = (lambda planes, nk, lib=lib:
                       radix_sort.launch_sort(lib, planes, nk), "all")
    for name in VARIANTS:
        lib = bitonic.build("bitonic_" + name.replace(" ", "_"),
                            variant_source(name))
        sorts["bitonic " + name] = (lambda planes, nk, lib=lib:
                                    _bitonic_sorted(lib, planes, nk), "keys")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    order = list(sorts) + list(reversed(sorts))
    for log2n in SIZES:
        n = 1 << log2n
        for c, nk in SHAPES:
            planes = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                                    device="cuda", generator=gen)
                      for _ in range(nk)]
            planes += [torch.arange(n, dtype=torch.int32, device="cuda")
                       for _ in range(c - nk)]
            planes = tuple(planes)
            want = bitonic.plain_sort(planes, nk)
            for name, (sort, compared) in sorts.items():
                got = sort(planes, nk)
                upto = c if compared == "all" else nk
                if not all(torch.equal(g, w)
                           for g, w in zip(got[:upto], want[:upto])):
                    raise RuntimeError(f"variant {name!r} sorts wrongly")
                del got
            del want
            times = {name: [] for name in sorts}
            for name in order:
                times[name].append(
                    _ms(lambda: sorts[name][0](planes, nk)))
            plain = _ms(lambda: bitonic.plain_sort(planes, nk))
            for name, (first, second) in times.items():
                print(f"2^{log2n} C={c} keys={nk} {name:28s} "
                      f"{first:.3f} / {second:.3f} ms", flush=True)
            print(f"2^{log2n} C={c} keys={nk} {'plain sort':28s} "
                  f"{plain:.3f} ms", flush=True)
            del planes
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

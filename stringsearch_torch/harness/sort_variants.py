"""What each design choice of the sort kernels and of the radix
destination kernel buys, on one GPU.

    python -m stringsearch_torch.harness.sort_variants [FAMILY ...]

The families are `sort`, `bitonic`, `dest` and `bitonic_passes`; with no
argument the first three run. `sort` builds
copies of `ops/csrc/radix_sort.cu` (the sort behind `device_sort`) with
one choice changed (the text replacements of RADIX_VARIANTS, each of
which must match its source exactly once: digit width, tile and block, how
a plane reaches shared memory, ballots or `__match_any_sync`), checks
every copy against the plain sort on every plane, and times each with
CUDA events at the main path's plane counts, at n = 2^24 and 2^28, on
full-range random int32 keys and on random ranks below n, each with
position planes as payload. A radix time includes the allocation of its
two scratch sets, as `radix_sort` makes them. The variants run in order,
then in reverse order, so a drift of the card's clock shows as a gap
between the two times of one variant.
`bitonic` does the same for copies of `ops/csrc/bitonic.cu` (VARIANTS:
the tile, the group width, the mirror's own pass, the swizzle, the stages
a round, the key count compiled in), at full-range random keys beside the
radix sort and the chained `torch.sort`; every copy runs the same
network, so each must equal the as-built copy on every plane and the
plain sort on its keys. A bitonic time includes the allocation of its
outputs, as `bitonic_sort` makes them.

`dest` does the same for `ss_radix_dest` of `ops/csrc/radix.cu`
(DEST_VARIANTS: how the lanes of a bin find each other, the form of the
vote loop, the warps that share a tile, the warps of a block, the registers
a thread may take): for every copy it prints what `cuobjdump` says of the
build (registers, stack, machine operations a segment), holds it against
`plain_dest`, then times it at n = 2^28, shift 24, on random, two-bin and
one-bin keys at tiles 1024, 2048 and 8192, two readings as above.

`bitonic_passes` gives the device time of each kind of pass of one
bitonic sort (`bitonic_passes_main`).

The copies are written to and built in `stringsearch_torch/_build/variants/`
(`Library.variant`). To time a kernel against an earlier design of it, run
the benchmark on a `git archive` of the earlier commit beside this one.
Needs a CUDA device.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from stringsearch_torch import harness
from stringsearch_torch.harness import BYTES_PER_S
from stringsearch_torch.ops import _build, bitonic, radix, radix_sort

# bitonic.cu
_TILE_WIDE = "constexpr int kTileLogWide = 13;"
_ROW = "constexpr int kRowLog = 5;"
_FUSE = "constexpr bool kFuseMirror = true;"
_SWIZZLE = "constexpr bool kSwizzle = true;"
_ROUND = "constexpr int kChunkStages = 3;"
_THREADS_B = "constexpr int kThreads = 512;"
_KEYS = "constexpr bool kKeysCompiled = true;"
VARIANTS = {
    "as built": (),
    # the earlier design's tile, 4096 elements, for C = 4..6 (and S = 7)
    "tile 4096": ((_TILE_WIDE, _TILE_WIDE.replace("13", "12")),),
    # group passes of S - 1 stages on rows of 64 elements
    "group stages S-1": ((_ROW, _ROW.replace("5", "6")),),
    # each level's mirror stage in a group pass of its own
    "no mirror fusion": ((_FUSE, _FUSE.replace("true", "false")),),
    # shared-memory words in order: bank conflicts in the rounds on bits
    # 5..3 and below
    "no swizzle": ((_SWIZZLE, _SWIZZLE.replace("true", "false")),),
    # two stages a shared-memory round trip instead of three
    "two stages a round": ((_ROUND, _ROUND.replace("3", "2")),),
    # four, 16 elements a thread, on blocks of 256 threads
    "four stages a round": ((_ROUND, _ROUND.replace("3", "4")),
                            (_THREADS_B, _THREADS_B.replace("512", "256"))),
    # the key count read at run time by one build for each plane count
    "key count at run time": ((_KEYS, _KEYS.replace("true", "false")),),
}

_TILE = "constexpr int kTile = 16384;"
_THREADS = "constexpr int kThreads = 512;"
_DIGITS = "constexpr int kDigitBits = 8;"
_LOAD = "constexpr int kLoad = 0;"
_WINDOW = "constexpr int kWindow = 16;"
# first statement of `lanes_of_digit`; a return in its line leaves the
# ballots unreached
_BALLOTS = "  unsigned peers = __ballot_sync(kFull, live);\n"
_MATCH_ANY = ("  return __match_any_sync(kFull, live ? b : kBins); "
              "unsigned peers = 0;\n")
_BLOCKS = "constexpr int kPassBlocks = 512 / kThreads;"


def _radix(digits=None, tile=None, threads=None, resident=None, load=None,
           window=None, match_any=False) -> tuple:
    """Edits of radix_sort.cu: the digit width, the tile (keys per block; a
    thread ranks tile / threads of them), the block, the resident threads
    per SM that cap the pass kernel's registers and set its grid, how a
    plane reaches shared memory (0 TMA, 1 `cp.async`, 2 registers), the
    predecessors the look-back reads at once, and how the lanes of one
    digit find each other."""
    edits = []
    if digits:
        edits.append((_DIGITS, _DIGITS.replace("8", str(digits))))
    if tile:
        edits.append((_TILE, _TILE.replace("16384", str(tile))))
    if threads:
        edits.append((_THREADS, _THREADS.replace("512", str(threads))))
    if resident:
        edits.append((_BLOCKS, _BLOCKS.replace("512", str(resident))))
    if load is not None:
        edits.append((_LOAD, _LOAD.replace("0", str(load))))
    if window:
        edits.append((_WINDOW, _WINDOW.replace("16", str(window))))
    if match_any:
        edits.append((_BALLOTS, _MATCH_ANY))
    return tuple(edits)


RADIX_VARIANTS = {
    "radix as built": (),
    "radix digits 10": _radix(digits=10),
    "radix digits 11 tile 8192": _radix(digits=11, tile=8192),
    "radix cp.async loads": _radix(load=1),
    "radix register loads": _radix(load=2),
    "radix look-back window 1": _radix(window=1),
    "radix look-back window 4": _radix(window=4),
    "radix match_any": _radix(match_any=True),
    "radix tile 16384 threads 1024": _radix(threads=1024, resident=1024),
    "radix tile 16384 threads 1024 cp.async loads": _radix(
        threads=1024, resident=1024, load=1),
    "radix tile 8192 threads 256": _radix(tile=8192, threads=256),
    "radix tile 8192 threads 256 digits 11": _radix(tile=8192, threads=256,
                                                    digits=11),
}
SHAPES = ((2, 1), (4, 3), (5, 4))  # (planes, keys): invert, initial, round
SIZES = (24, 28)


# radix.cu, the destination kernel
_PER_LANE = "constexpr int kDestPerLane = 32;"
_BLOCK_WARPS = "constexpr int kDestBlockWarps = 8;"
_RESIDENT = "constexpr int kDestResident = 768;"
# first statement of `lanes_of_bin`, as _BALLOTS is of `lanes_of_digit`
_LIVE_LANES = "  unsigned peers = live_lanes;\n"
_DEST_MATCH_ANY = ("  return __match_any_sync(kFull, (live_lanes >> "
                   "(threadIdx.x & 31)) & 1 ? b : kBins); "
                   "unsigned peers = 0;\n")
# the two statements of the bit loop that use the vote, and the form that
# picks the vote or its complement by the bit
_SIGN_VOTE = """    const unsigned vote = __ballot_sync(kFull, x < 0);
    peers &= ~(vote ^ static_cast<unsigned>(x >> 31));
"""
_SELECT_VOTE = """    const unsigned vote = __ballot_sync(kFull, b >> bit & 1);
    peers &= (b >> bit) & 1 ? vote : ~vote;
"""
# the ranking loop's way out, and the form that tests every segment
_BREAK = """    if (j >= whole) break;
    held[j] = ranked<true>(held[j], shift, count, kFull);
"""
_SKIP = """    if (j < whole)
    held[j] = ranked<true>(held[j], shift, count, kFull);
"""
_DEST_TILES = (1024, 2048, 8192)


def _dest(match_any=False, per_lane=None, block_warps=None, resident=None,
          warps=None, select_votes=False, skip=False) -> tuple:
    """(edits of radix.cu, warps per tile by tile). The edits: how the lanes
    of a bin find each other, the keys a lane holds, the warps of a block,
    the resident threads per SM the kernel is compiled for, which cap its
    registers, the vote or its complement picked by the bit in place of the
    sign-bit form, and a test of every segment of the unrolled ranking loop
    in place of the one way out. `warps` replaces
    `radix.dest_warps_per_tile` for the tiles it names."""
    edits = []
    if match_any:
        edits.append((_LIVE_LANES, _DEST_MATCH_ANY))
    if select_votes:
        edits.append((_SIGN_VOTE, _SELECT_VOTE))
    if skip:
        edits.append((_BREAK, _SKIP))
    if per_lane:
        edits.append((_PER_LANE, _PER_LANE.replace("32", str(per_lane))))
    if block_warps:
        edits.append((_BLOCK_WARPS,
                      _BLOCK_WARPS.replace("8", str(block_warps))))
    if resident:
        edits.append((_RESIDENT, _RESIDENT.replace("768", str(resident))))
    return tuple(edits), dict(warps or {})


DEST_VARIANTS = {
    "dest as built": _dest(),
    "dest match_any": _dest(match_any=True),
    "dest vote or its complement by the bit": _dest(select_votes=True),
    "dest tests every segment of the loop": _dest(skip=True),
    "dest block of 4 warps": _dest(block_warps=4),
    "dest block of 16 warps": _dest(block_warps=16),
    "dest resident 512 threads": _dest(resident=512),
    "dest resident 1024 threads": _dest(resident=1024),
    "dest resident 1536 threads": _dest(resident=1536),
    "dest resident 2048 threads": _dest(resident=2048),
    "dest half the warps 64 keys a lane": _dest(
        per_lane=64, warps={2048: 1, 8192: 4}),
    "dest twice the warps 16 keys a lane": _dest(
        per_lane=16, warps={1024: 2, 2048: 4, 8192: 16}),
    "dest twice the warps": _dest(warps={1024: 2, 2048: 4, 8192: 16}),
    "dest four times the warps": _dest(warps={1024: 4, 2048: 8, 8192: 32}),
}


def variant_source(name: str) -> str:
    """Write the patched copy of variant `name`'s source; returns its path."""
    if name in RADIX_VARIANTS:
        return harness.variant_source(name, radix_sort._SOURCE,
                                      RADIX_VARIANTS[name])
    if name in DEST_VARIANTS:
        return harness.variant_source(name, radix._SOURCE,
                                      DEST_VARIANTS[name][0])
    return harness.variant_source("bitonic " + name, bitonic._SOURCE,
                                  VARIANTS[name])


def _bitonic_sorted(lib, planes, nk):
    out = tuple(torch.empty_like(p) for p in planes)
    bitonic.launch_sort(lib, planes, out, nk)
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


def _launch_dest(lib, keys, tile: int, warps: int) -> tuple:
    n = keys.shape[0]
    dest = torch.empty_like(keys)
    local_base = torch.empty((n // tile, 256), dtype=torch.int32,
                             device=keys.device)
    lib.call("ss_radix_dest", keys.device, keys.data_ptr(), n, tile, 24,
             warps, dest.data_ptr(), local_base.data_ptr())
    return dest, local_base


def _dest_code(lib) -> str:
    """What `cuobjdump` says of the destination kernel's builds in `lib`:
    registers and stack (spills) of each, and the machine operations from
    the first vote of one unrolled segment to the first vote of the next
    (eight votes a segment), the median over the unrolled loop."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, lib.load()._name],
                              capture_output=True, text=True).stdout

    usage = dict(re.findall(
        r"Function \S*dest_kernelILi(\d+)E\S*:\s*\n\s*(REG:\d+ STACK:\d+)",
        dump("-res-usage")))
    out = []
    for body in dump("-sass").split("Function : ")[1:]:
        build = re.match(r"\S*dest_kernelILi(\d+)E", body)
        if not build:
            continue
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(\S+)", body, re.M)
        votes = [i for i, op in enumerate(ops) if op.startswith("VOTE")]
        # the unrolled loop comes first in the code; the compiler's copies
        # of the votes for a diverged warp, which never run, follow it
        strides = sorted(
            b - a for a, b in list(zip(votes[::8], votes[8::8]))[:31])
        per_segment = strides[len(strides) // 2] if strides else None
        out.append(f"<{build[1]}> {usage.get(build[1], 'usage not found')} "
                   f"{per_segment} operations a segment")
    return "; ".join(out)


def dest_main() -> None:
    """Check and time every copy of the destination kernel."""
    # name -> (library, warps per tile by tile); one nvcc each, side by side
    with ThreadPoolExecutor(len(DEST_VARIANTS)) as pool:
        libs = list(pool.map(
            lambda name: radix.LIBRARY.variant(variant_source(name)),
            DEST_VARIANTS))
    built = {}
    for (name, (_, warps)), lib in zip(DEST_VARIANTS.items(), libs):
        built[name] = (lib, {t: warps.get(t, radix.dest_warps_per_tile(t))
                             for t in _DEST_TILES})
    for name, (lib, _) in built.items():
        print(f"{name:40s} {_dest_code(lib)}", flush=True)
    n = 1 << 28
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         device="cuda", generator=gen)
    low24 = keys & 0x00FFFFFF
    two_tops = torch.tensor([3 << 24, (250 << 24) - 2**32], dtype=torch.int32,
                            device="cuda")
    key_sets = {
        "random": keys,
        "two bins": low24 | two_tops[torch.randint(
            0, 2, (n,), device="cuda", generator=gen)],
        "one bin": low24 | (7 << 24),
    }
    del low24
    order = list(built) + list(reversed(built))
    for tile in _DEST_TILES:
        for kind, k in key_sets.items():
            want = radix.plain_dest(k, tile, 24)
            for name, (lib, warps) in built.items():
                got = _launch_dest(lib, k, tile, warps[tile])
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"variant {name!r} ranks wrongly at "
                                       f"tile {tile} on {kind} keys")
                del got
            del want
            times = {name: [] for name in built}
            for name in order:
                lib, warps = built[name]
                times[name].append(_ms(
                    lambda: _launch_dest(lib, k, tile, warps[tile]), reps=5))
            for name, (first, second) in times.items():
                print(f"2^28 tile={tile} {kind:8s} {name:36s} "
                      f"warps={built[name][1][tile]:2d} "
                      f"{first:.4f} / {second:.4f} ms", flush=True)


def _keyed_planes(kind: str, n: int, c: int, nk: int, gen) -> tuple:
    """nk key planes of full-range random int32 ("random") or of random
    ranks below n ("ranks", the main path's own keys), then c - nk position
    planes."""
    hi = 2**31 - 1 if kind == "random" else n
    lo = -2**31 if kind == "random" else 0
    planes = [torch.randint(lo, hi, (n,), dtype=torch.int32, device="cuda",
                            generator=gen) for _ in range(nk)]
    planes += [torch.arange(n, dtype=torch.int32, device="cuda")
               for _ in range(c - nk)]
    return tuple(planes)


def _sweep(sorts: dict, sizes, kinds, reps: int = 3) -> None:
    """Check every sort of `sorts` (name -> sort) against the plain sort
    on every plane, then time each with CUDA events, in order and in
    reverse order, at the main path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    order = list(sorts) + list(reversed(sorts))
    for log2n in sizes:
        n = 1 << log2n
        for kind in kinds:
            for c, nk in SHAPES:
                planes = _keyed_planes(kind, n, c, nk, gen)
                want = bitonic.plain_sort(planes, nk)
                for name, sort in sorts.items():
                    got = sort(planes, nk)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"variant {name!r} sorts wrongly")
                    del got
                del want
                times = {name: [] for name in sorts}
                for name in order:
                    times[name].append(
                        _ms(lambda: sorts[name](planes, nk), reps))
                label = f"2^{log2n} {kind} C={c} keys={nk}"
                for name, (first, second) in times.items():
                    print(f"{label} {name:40s} {first:.4f} / {second:.4f} ms",
                          flush=True)
                del planes
                torch.cuda.empty_cache()


def sort_main() -> None:
    """Check and time every copy of the radix sort."""
    sorts = {}
    for name in RADIX_VARIANTS:
        lib = radix_sort.LIBRARY.variant(variant_source(name))
        sorts[name] = (lambda planes, nk, lib=lib:
                       radix_sort.launch_sort(lib, planes, nk))
    _sweep(sorts, SIZES, ("random", "ranks"))


def bitonic_main() -> None:
    """Check and time every copy of the bitonic sort, beside the chained
    `torch.sort` and the radix sort. Every copy runs the same network, so
    each must equal the as-built copy on every plane, and its keys the
    plain sort's."""
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(
            lambda name: bitonic.LIBRARY.variant(variant_source(name)),
            names))
    sorts = {"bitonic " + name: (lambda planes, nk, lib=lib:
                                 _bitonic_sorted(lib, planes, nk))
             for name, lib in zip(names, libs)}
    sorts["radix sort"] = radix_sort.radix_sort
    sorts["plain sort"] = bitonic.plain_sort
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    order = list(sorts) + list(reversed(sorts))
    for log2n in SIZES:
        n = 1 << log2n
        for c, nk in SHAPES:
            planes = _keyed_planes("random", n, c, nk, gen)
            want = bitonic.plain_sort(planes, nk)
            built = sorts["bitonic as built"](planes, nk)
            if not all(torch.equal(g, w) for g, w in zip(built[:nk],
                                                         want[:nk])):
                raise RuntimeError("the bitonic sort's keys are wrong")
            del want
            for name, sort in sorts.items():
                if not name.startswith("bitonic"):
                    continue
                got = sort(planes, nk)
                if not all(torch.equal(g, w) for g, w in zip(got, built)):
                    raise RuntimeError(f"{name!r} differs from as built")
                del got
            del built
            times = {name: [] for name in sorts}
            for name in order:
                times[name].append(
                    _ms(lambda: sorts[name](planes, nk),
                        1 if log2n >= 28 and name.startswith("bitonic")
                        else 3))
            label = f"2^{log2n} random C={c} keys={nk}"
            for name, (first, second) in times.items():
                print(f"{label} {name:40s} {first:.4f} / {second:.4f} ms",
                      flush=True)
            print(f"{label} passes {len(bitonic.schedule(n, c))}, bound "
                  f"{8 * c * n / BYTES_PER_S * 1e3:.4f} ms", flush=True)
            del planes
            torch.cuda.empty_cache()


def bitonic_passes_main() -> None:
    """The device time of each pass of one bitonic sort, from
    `torch.profiler`, summed by kind (sort; group, with the mirror or not,
    by its stages; tile), at 2^24 and 2^28 at the main path's shapes,
    each beside one pass's bytes (every plane read and written once)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for log2n in SIZES:
        n = 1 << log2n
        for c, nk in SHAPES:
            planes = _keyed_planes("random", n, c, nk, gen)
            bitonic.bitonic_sort(planes, nk)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                bitonic.bitonic_sort(planes, nk)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if str(e.device_type).endswith("CUDA")
                             and "pass_kernel" in e.name),
                            key=lambda e: e.time_range.start)
            passes = bitonic.schedule(n, c)
            if len(events) != len(passes):
                raise RuntimeError(f"{len(events)} kernels for "
                                   f"{len(passes)} passes")
            kinds = {}
            for p, e in zip(passes, events):
                kind = p.kind
                if p.kind == "group":
                    kind += (" with mirror" if p.hi == p.level - 1 else "") \
                        + f" w={p.hi - p.lo + 1}"
                count, ms = kinds.get(kind, (0, 0.0))
                kinds[kind] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
            one = 8 * c * n / BYTES_PER_S * 1e3
            total = sum(ms for _, ms in kinds.values())
            print(f"2^{log2n} C={c} keys={nk}: {total:.4f} ms in "
                  f"{len(passes)} passes, one pass's bytes {one:.4f} ms; "
                  + "; ".join(f"{k} {cnt} x {ms / cnt:.4f} ms "
                              f"({one / (ms / cnt):.3f} of bytes)"
                              for k, (cnt, ms) in sorted(kinds.items())),
                  flush=True)
            del planes
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    families = {"sort": sort_main, "bitonic": bitonic_main,
                "dest": dest_main, "bitonic_passes": bitonic_passes_main}
    chosen = list(sys.argv[1:] if argv is None else argv) or [
        "sort", "bitonic", "dest"]
    for name in chosen:
        if name not in families:
            raise SystemExit(f"unknown family {name!r}: {sorted(families)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in chosen:
        families[name]()


if __name__ == "__main__":
    main()

"""What each design choice of the bitonic kernel buys, on one GPU.

    python -m stringsearch_torch.harness.sort_variants

Builds copies of `ops/csrc/bitonic.cu` with one choice changed (the text
replacements in VARIANTS, each of which must match the source exactly
once), checks every copy's keys against the plain sort, and times each
with CUDA events at the main path's plane counts, at n = 2^24 and 2^28:
random int32 keys plus a position plane. A time includes the copy of the
input planes, as `bitonic_sort` makes one. The variants run in order, then
in reverse order, so a drift of the card's clock shows as a gap between
the two times of one variant. The copies are written to and built in
`stringsearch_torch/_build/variants/`. Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess

import torch

from stringsearch_torch.ops import _build, bitonic

_DEVICE_STAGES = "constexpr int kGlobalGroupStages = 3;"
_TILE_STAGES = "constexpr int kTileGroupStages = 2;"
_SHARED_INDEX = "return s[q * tile + i];"

VARIANTS = {
    "as built": (),
    "device stages 2": ((_DEVICE_STAGES, _DEVICE_STAGES.replace("3", "2")),),
    "device stages 1": ((_DEVICE_STAGES, _DEVICE_STAGES.replace("3", "1")),),
    "tile stages 1": ((_TILE_STAGES, _TILE_STAGES.replace("2", "1")),),
    # XOR of bits 2..6 into bits 0..4 of the shared-memory index
    "swizzle": ((_SHARED_INDEX,
                 "return s[q * tile + (i ^ ((i >> 2) & 31))];"),),
}
SHAPES = ((2, 1), (4, 3), (5, 4))  # (planes, keys): invert, initial, round
SIZES = (24, 28)


def variant_source(name: str) -> str:
    with open(bitonic._SOURCE) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} does not occur "
                               f"exactly once in {bitonic._SOURCE}")
        src = src.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, "variants",
                        name.replace(" ", "_") + ".cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def _sorted_copy(lib, planes, nk):
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
    libs = {name: bitonic.build("bitonic_" + name.replace(" ", "_"),
                                variant_source(name)) for name in VARIANTS}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for log2n in SIZES:
        n = 1 << log2n
        for c, nk in SHAPES:
            planes = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                                    device="cuda", generator=gen)
                      for _ in range(nk)]
            planes += [torch.arange(n, dtype=torch.int32, device="cuda")
                       for _ in range(c - nk)]
            want = bitonic.plain_sort(planes, nk)[:nk]
            for name, lib in libs.items():
                got = _sorted_copy(lib, planes, nk)[:nk]
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"variant {name!r} sorts wrongly")
                del got
            del want
            times = {name: [] for name in VARIANTS}
            for name in order:
                times[name].append(
                    _ms(lambda: _sorted_copy(libs[name], planes, nk)))
            plain = _ms(lambda: bitonic.plain_sort(planes, nk))
            for name, (first, second) in times.items():
                print(f"2^{log2n} C={c} keys={nk} {name:16s} "
                      f"{first:.3f} / {second:.3f} ms", flush=True)
            print(f"2^{log2n} C={c} keys={nk} {'plain sort':16s} "
                  f"{plain:.3f} ms", flush=True)
            del planes
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""The step kernels' share of their roofline, in %: the bytes bound of
every `pack_keys`, `shift_planes` and `head_ranks` call (17n, 20n, and
20n or 16n bytes on the flat build, at the card's 3.35 TB/s) over the
device time of those three kernels."""

PATTERN = r"(?<![A-Za-z0-9_])(pack_keys|shift_planes|head_ranks)_kernel\b"


def read(trace):
    return trace.roofline_pct(PATTERN, "pack_keys", "shift_planes",
                              "head_ranks")

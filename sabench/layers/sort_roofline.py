"""The sort's share of its roofline, in %: the bytes bound of every
`device_sort` call (each plane read and written once, 8 C n bytes for C
int32 planes, at the card's 3.35 TB/s) over the device time of the radix
sort's kernels (`sort_hist_kernel`, `sort_plan_kernel`,
`sort_pass_kernel`)."""

PATTERN = r"\bsort_(hist|plan|pass)_kernel\b"


def read(trace):
    return trace.roofline_pct(PATTERN, "device_sort")

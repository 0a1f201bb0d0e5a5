"""What a traced run reads: the profiler's device and host events over the
traced units, the host's waits for the device, and the program's calls to
the steps whose bytes bound its kernels.

Frozen copies, with their sources: `short_name` and the per-kernel sums
are `stringsearch_torch/harness/profile_build.py:_short` and
`_kernel_sums`; `count_syncs` is its `_syncs`. The idle share is taken
from the union of the device's busy intervals inside the traced window,
not from summed kernel time, which overlapping kernels push past the
window (profile_build's arithmetic read -0.0011 and -0.0019). On a cell
of k cards each card's union is taken apart: busy and idle are
card-seconds, and the busy time reported is the mean over the cards.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import re
import traceback
import warnings
from collections import defaultdict

import torch

from sabench import peaks

WINDOW = "sabench.window"
# the profiler's own host events, which are no work of the program
_PROFILER_OWN = ("Activity Buffer Request",)


def short_name(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    return re.sub(r"\((?!\().*$", "", name).strip()[:72]


@dataclasses.dataclass
class Trace:
    """One traced window. Times in microseconds on the profiler's clock."""

    kind: str
    units: int
    window: tuple
    device_ops: list  # (short name, start, end)
    host_ops: list  # (name, start, end), sorted by start
    calls: list  # (program function, bytes its kernel must move)
    syncs: list  # host waits of each counted unit
    sort_launches: int  # the program's radix sorts over the traced units
    # each device op's card, as its place (0 .. cards - 1) among the
    # cell's cards; None: every op on the one card
    device_cards: list | None = None
    cards: int = 1

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def _card_ops(self, card) -> list:
        if card is None or self.device_cards is None:
            return self.device_ops if card in (None, 0) else []
        return [op for op, c in zip(self.device_ops, self.device_cards)
                if c == card]

    def busy_intervals(self, card: int | None = None) -> list:
        """The union of a card's busy intervals (with None, of every
        card's together), clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1))
                       for _, s, e in self._card_ops(card)
                       if e > w0 and s < w1)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us_per_card(self) -> list:
        """Each card's busy time in the window, in card order."""
        return [sum(e - s for s, e in self.busy_intervals(c))
                for c in range(self.cards)]

    def busy_us(self) -> float:
        """The mean over the cards of each card's busy time."""
        per = self.busy_us_per_card()
        return sum(per) / len(per)

    def device_time_us(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.device_ops if rx.search(name))

    def call_bytes(self, *functions: str) -> int:
        return sum(b for name, b in self.calls if name in functions)

    def roofline_pct(self, pattern: str, *functions: str) -> float | None:
        """100 x (bytes bound of the calls) / (device time of their
        kernels), or None where either is missing."""
        nbytes = self.call_bytes(*functions)
        device_us = self.device_time_us(pattern)
        if not nbytes or not device_us:
            return None
        return 100.0 * peaks.bound_s(nbytes) / (device_us * 1e-6)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the innermost host events across each
        gap's middle), each card's gaps summed, in seconds, at most `top`
        of each."""
        per = defaultdict(float)
        for name, s, e in self.device_ops:
            per[name] += (e - s) * 1e-6
        gaps = defaultdict(float)
        w0, w1 = self.window
        starts = [h[1] for h in self.host_ops]
        for card in range(self.cards):
            busy = self.busy_intervals(card)
            edges = [w0] + [x for iv in busy for x in iv] + [w1]
            for g0, g1 in zip(edges[0::2], edges[1::2]):
                if g1 > g0:
                    gaps[self._host_at((g0 + g1) / 2, starts)] += (
                        (g1 - g0) * 1e-6)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(per)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}

    def _host_at(self, t: float, starts: list) -> str:
        """The two innermost host events running at time t."""
        i = bisect.bisect_right(starts, t)
        inside = []
        for name, s, e in reversed(self.host_ops[max(0, i - 400):i]):
            if e >= t and name != WINDOW:
                inside.append((s, name))
        if not inside:
            return "host Python between traced ops"
        inside.sort()
        return " > ".join(name for _, name in inside[-2:])


def sync_all(devices) -> None:
    """Wait for each CUDA card among `devices` (a mesh may repeat one)."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def profiled(fn, devices):
    """Run fn() under the profiler, inside the window span, and wait for
    every card of `devices` before the profiler closes; returns (fn's
    result, the profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            out = fn()
        sync_all(devices)
    return out, prof


def read_profile(prof, devices, **fields) -> Trace:
    """The Trace of a profiler run made by `profiled`, each device op on
    its card's place among the cell's `devices`."""
    device, cards, host, window = [], [], [], None
    place = {}
    for i, d in enumerate(devices):
        if d.type == "cuda":
            place.setdefault(d.index, i)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name == WINDOW:
            # the span shows on the device's timeline too: no device work
            if not str(e.device_type).endswith("CUDA"):
                window = (start, end)
        elif str(e.device_type).endswith("CUDA"):
            if e.device_index not in place:
                raise RuntimeError(f"{e.name} ran on card {e.device_index}, "
                                   f"not one of the cell's {devices}")
            device.append((short_name(e.name), start, end))
            cards.append(place[e.device_index])
        elif e.name not in _PROFILER_OWN:
            host.append((e.name, start, end))
    host.sort(key=lambda h: h[1])
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window=window, device_ops=device, host_ops=host,
                 device_cards=cards, cards=len(devices), **fields)


def count_syncs(fn) -> tuple[object, list]:
    """fn(), and for each time the program made the host wait for the
    device (`torch.cuda.set_sync_debug_mode` warns once for each) its
    innermost frame: (fn's result, ["module/file.py:line", ...]). Waits
    outside the program (the harness's own synchronize) are not counted."""
    sites = []
    package = f"{os.sep}stringsearch_torch{os.sep}"

    def seen(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if package in f.filename]
        if frames:
            sites.append(f"{frames[-1].filename.split(package)[-1]}:"
                         f"{frames[-1].lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


class CallLog:
    """While entered, the doubling engine's sorts and steps are wrapped to
    log (function, bytes its kernel must move), read at the call from the
    operands and outputs. It patches module attributes of the program
    until the program records such counts itself."""

    def __init__(self):
        self.calls = []
        self._saved = {}

    def __enter__(self):
        from stringsearch_torch.engines import doubling

        self._module = doubling
        log = self.calls.append
        sort, pack, shift, heads = (doubling.device_sort, doubling.pack_keys,
                                    doubling.shift_planes,
                                    doubling.head_ranks)

        def device_sort(operands, num_keys=1):
            operands = tuple(operands)
            out = sort(operands, num_keys)
            log(("device_sort", peaks.sort_bytes(operands)))
            return out

        def pack_keys(text, *args, **kwargs):
            out = pack(text, *args, **kwargs)
            log(("pack_keys", peaks.pack_keys_bytes(text, out)))
            return out

        def shift_planes(rank, *args, **kwargs):
            out = shift(rank, *args, **kwargs)
            log(("shift_planes", peaks.shift_planes_bytes(rank, out)))
            return out

        def head_ranks(planes):
            out = heads(planes)
            log(("head_ranks", peaks.head_ranks_bytes(planes, out[1])))
            return out

        for name, fn in (("device_sort", device_sort),
                         ("pack_keys", pack_keys),
                         ("shift_planes", shift_planes),
                         ("head_ranks", head_ranks)):
            self._saved[name] = getattr(doubling, name)
            setattr(doubling, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._module, name, fn)
        return False

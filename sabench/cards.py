"""A traced window on several cards, read card by card, for the readers
of `layers/` whose cell runs one program over k cards.

The program's recorder gives each span the device time of the operations
launched between its markers by pairing the k-th launching host call of
the trace with the k-th device operation (`spans.of`). That pairing holds
on one stream. One host thread that drives four cards fills four streams,
which run side by side, so the operations begin in another order than the
host launched them, and the pairing does not hold. On each card the
stream still runs its operations in the order they were launched there.
So these readers take one family of operations at a time, by name (the
radix sort's kernels, the copies between cards, a kernel library's
kernels), and where they need a call's own time they pair each card's
calls of the family, in the order they ran, with the spans that launched
them on that card, in the order the host recorded them. Where the two
counts differ on a card they read nothing. The profiler now and then
leaves a copy between cards out of a four-card trace (a record in a few
hundred, in some windows and not others), so the copies are summed by
name, never paired; the radix sorts' kernels have always been whole.

A card is its place among the cell's devices (`Trace.device_cards`),
which is its CUDA index: the cell's cards are cuda:0 .. cuda:k-1.
"""

from __future__ import annotations

import re

from sabench import peaks, peaks_global

BUILD = "global.build"
# one radix sort launch: its scratch memset, then these kernels, in order
SORT_FIRST = re.compile(r"\bsort_hist_kernel\b")
SORT_KERNELS = re.compile(r"\bsort_(hist|plan|pass)_kernel\b")
MEMSET = "Memset"
# a copy between two cards, on the source card's stream
PEER_COPY = re.compile(r"^Memcpy PtoP\b")


def builds(records) -> int:
    """The number of global builds the spans hold."""
    return sum(s.name == BUILD for s in records)


def by_card(trace) -> list:
    """Each card's device operations (name, start, end), in the order
    they ran."""
    out = [[] for _ in range(trace.cards)]
    cards = trace.device_cards or [0] * len(trace.device_ops)
    for op, card in zip(trace.device_ops, cards):
        out[card].append(op)
    for ops in out:
        ops.sort(key=lambda op: op[1])
    return out


def family_us(trace, pattern) -> float:
    """The summed device time of the operations whose name matches, on
    every card, in us."""
    rx = re.compile(pattern)
    return sum(e - s for name, s, e in trace.device_ops if rx.search(name))


def sort_runs(ops) -> list:
    """One card's radix sorts, in the order they ran: each the device time
    (us) of a `sort_hist_kernel`, the sort kernels that follow it, and the
    memset just before it."""
    out = []
    for i, (name, s, e) in enumerate(ops):
        if SORT_KERNELS.search(name):
            if SORT_FIRST.search(name):
                before = ops[i - 1] if i else None
                out.append(before[2] - before[1] if before and
                           before[0] == MEMSET else 0.0)
            if out:
                out[-1] += e - s
    return out


def paired(per_card_ops, per_card_spans) -> list | None:
    """[(span, us)]: each card's operations paired in order with that
    card's spans; None where a card's counts differ."""
    out = []
    for ops, owners in zip(per_card_ops, per_card_spans):
        if len(ops) != len(owners):
            return None
        out.extend(zip(owners, ops))
    return out


def sorts(trace, records) -> list | None:
    """[(the `ops.device_sort` span, its device time in us)] for every sort
    of the window that ran on a card: each card's radix sorts in the order
    they ran, paired with the sort spans whose `card` is that card, in the
    order they began (a sort of fewer than 2 elements launches none).
    None where the counts differ."""
    spans_of = [[] for _ in range(trace.cards)]
    for s in records:
        card = s.attrs.get("card") if s.name == "ops.device_sort" else None
        if card is not None and s.attrs["n"] >= 2 and card < trace.cards:
            spans_of[card].append(s)
    return paired([sort_runs(ops) for ops in by_card(trace)], spans_of)


def span_roofline(trace, records, names, kernels) -> float | None:
    """100 x the least time the card needs for the bound bytes of every
    span named in `names` (`peaks_global`), over the device time of the
    kernels whose names match `kernels` on every card; None without a
    global build, a byte or a kernel."""
    if trace.kind != "build" or not builds(records):
        return None
    nbytes = sum(peaks_global.span_bytes(s) for s in records
                 if s.name in names)
    us = family_us(trace, kernels)
    if not nbytes or not us:
        return None
    return 100.0 * peaks.bound_s(nbytes) / (us * 1e-6)

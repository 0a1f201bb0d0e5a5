"""Diffable phase traces, and the program's spans.

`Tracer` is the counterpart of stringsearch_tpu/harness/tracing.py, with
the same text format: `:: label` headers and array dumps of 25 values a
line, so a trace of the port diffs cleanly against one of the JAX package
or of the host oracle. Tracing selects a separate execution path
(`engines/doubling.py`, `sort_traced`); the fast path carries no tracing
code.

`span`, `wait_span` and `records` time the program's own layers: the
doubling engine's phases, rounds and waits, `device_sort` and the steps
between the sorts. Recording is on while a `torch.profiler` session is
active and off otherwise; off, a span is one check and returns a shared
object that does nothing. On, each span keeps its name, its parent, its
attributes and a clock read (`time.perf_counter_ns`) at its entry and at
its exit. Zero-width markers (`ANCHOR`, no device work inside) in the
profiler's trace tie that clock to the profiler's: one at the entry and
the exit of each outermost span, and one at the entry of each
`wait_span`, where the host is still ahead of the device. `records` maps
every clock read onto the profiler's clock through the markers either
side of it, and gives each span the device time of the device operations
launched inside it, from the profiler's own records. The spans are not
`record_function` ranges, which would also appear on the device's
timeline over the kernels they hold; they record no CUDA event; and
between a wait's end and the next launch, when the device is idle and
any host work delays it, they place no marker. Recording adds no host
wait and launches no kernel.

A recording session runs from the first span recorded with the profiler
on to the first time the recorder sees it off: a span entered, or
`records` called, with no profiler active. The next recorded span starts a
new session and drops the records of the last. This module imports
nothing of the package, so `ops/` and `engines/` import it freely.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import os
import threading
import time
from typing import IO, Optional

import numpy as np
import torch

PER_LINE = 25
# the name of the zero-width markers that place the spans in the profiler's
# trace
ANCHOR = "stringsearch_torch.clock"
# the host calls that put one operation on a CUDA stream, by prefix
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
            "cuMemset")


class Tracer:
    """Writes phase labels and array dumps to a text file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f: Optional[IO[str]] = open(path, "w")

    def log(self, msg: str) -> None:
        assert self._f is not None
        self._f.write(f":: {msg}\n")

    def dump(self, label: str, arr) -> None:
        """Array dump, 25 values a line. `arr` is a host array or a tensor
        on any device (fetched with one copy)."""
        assert self._f is not None
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        a = np.asarray(arr).ravel()
        self._f.write(f":: {label} len={a.size}\n")
        for i in range(0, a.size, PER_LINE):
            row = a[i : i + PER_LINE]
            self._f.write(" ".join(str(int(v)) for v in row) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span. `index` numbers the spans of a session in the
    order they began; `parent` is the enclosing span's index, None for an
    outermost one. Host times in microseconds, on the profiler's clock
    when `records` was given the profiler's host events, else on
    `time.perf_counter`'s. `device_ms` is the summed device time of the
    operations launched inside the span, None where it launched none or
    `records` was given no device operations to read."""

    name: str
    index: int
    parent: int | None
    attrs: dict
    start_us: float
    end_us: float
    device_ms: float | None


def planes(tensors) -> tuple:
    """(elements, bytes an element) of each tensor: the attribute form of
    the planes a step reads or writes."""
    return tuple((t.numel(), t.element_size()) for t in tensors)


class _Off:
    """What `span` returns while nothing records: a context manager that
    does nothing, false in a test."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Record:
    """A span being recorded; `Recorder.span` returns it."""

    __slots__ = ("_rec", "name", "attrs", "wait", "index", "parent", "top",
                 "start", "end", "marks")

    def __init__(self, recorder: "Recorder", name: str, attrs: dict,
                 wait: bool):
        self._rec = recorder
        self.name = name
        self.attrs = attrs
        self.wait = wait
        self.end = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        """Set attributes of the span, at any time before `records`."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Record":
        self._rec._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._rec._exit(self)
        return False


def _marker(name: str):
    """A host range in the profiler's trace with no device work inside:
    the profiler's narrowest range, since its width bounds the error of
    placing spans by it (`record_function`'s is several times wider)."""
    return torch._C._profiler._RecordFunctionFast(name)


class Recorder:
    """The spans of the newest recording session (see the module's
    docstring). One recorder serves the process; spans nest per thread,
    and their device times assume that one thread launches."""

    def __init__(self):
        self._local = threading.local()
        self._records: list = []
        self._clock: list = []  # perf_counter_ns of each marker
        self._live = False

    def span(self, name: str, **attrs):
        """A context manager that records span `name` while a profiler is
        active, and the shared no-op `OFF` otherwise."""
        return self._open(name, attrs, False)

    def wait_span(self, name: str, **attrs):
        """`span` around a host wait for the device: it marks its entry,
        made while the device is still busy, so that the spans after the
        wait need no marker of their own."""
        return self._open(name, attrs, True)

    def _open(self, name: str, attrs: dict, wait: bool):
        if not torch.autograd._profiler_enabled():
            self._live = False
            return OFF
        return _Record(self, name, attrs, wait)

    def _mark(self) -> int:
        with _marker(ANCHOR):
            self._clock.append(time.perf_counter_ns())
        return len(self._clock) - 1

    def _enter(self, r: _Record) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if not self._live:
            self._records, self._clock, self._live = [], [], True
        if stack:
            r.parent, r.top = stack[-1].index, stack[-1].top
            if r.wait:
                self._mark()
        else:
            r.parent, r.top = None, r
            r.marks = (self._mark(), None)
        r.index = len(self._records)
        self._records.append(r)
        stack.append(r)
        r.start = time.perf_counter_ns()

    def _exit(self, r: _Record) -> None:
        r.end = time.perf_counter_ns()
        stack = self._local.stack
        stack.pop()
        if not stack:
            r.marks = (r.marks[0], self._mark())

    def records(self, host_ops=None, device_ops=None) -> list:
        """The finished spans of the newest session, in the order they
        began, as `Span`s.

        `host_ops`, the profiler's host events of that session as (name,
        start_us, end_us), puts the host times on the profiler's clock:
        the session's markers are the trace's newest `ANCHOR` events, in
        order, each clock read is placed on the line through the markers
        either side of it, and a span whose outermost span's markers the
        trace lacks is left out, so a trace that holds none of this
        session's markers gives no spans. `device_ops`, the profiler's
        device operations as (name, start_us, end_us), gives each span its
        device time: on one stream the k-th launching host call
        (`LAUNCHES`) of the trace put the k-th operation there, and a
        span's operations are those launched between its entry and its
        exit. Where the two counts differ, no span gets a device time."""
        if not torch.autograd._profiler_enabled():
            self._live = False
        if host_ops is None:
            def place(t):
                return t / 1e3
            placed = None
        else:
            placed = _placed(len(self._clock), host_ops)
            place = _line(self._clock, placed)
        busy = _launched(host_ops or (), device_ops or ())
        out = []
        for r in self._records:
            if r.end is None or r.top.end is None:
                continue
            if placed is not None and not all(
                    i in placed for i in r.top.marks):
                continue
            start, end = place(r.start), place(r.end)
            device_ms = None
            if busy is not None:
                launches, cum = busy
                i = bisect.bisect_left(launches, start)
                j = bisect.bisect_left(launches, end)
                if j > i:
                    device_ms = (cum[j] - cum[i]) / 1e3
            out.append(Span(r.name, r.index, r.parent, dict(r.attrs), start,
                            end, device_ms))
        return out


def _placed(marks: int, host_ops) -> dict:
    """{mark index: its time on the profiler's clock} for the newest
    `marks` markers of the session, paired with the newest `ANCHOR`
    events of `host_ops`."""
    theirs = sorted((s + e) / 2 for name, s, e in host_ops if name == ANCHOR)
    k = min(marks, len(theirs))
    return dict(zip(range(marks - k, marks), theirs[len(theirs) - k:]))


def _line(clock: list, placed: dict):
    """The map from perf_counter_ns to the profiler's microseconds through
    the placed markers either side of a time (the nearest two at either
    end)."""
    at = sorted(placed)
    ts = [clock[i] for i in at]

    def place(t: int) -> float:
        if len(at) < 2:
            return float("nan")
        j = min(max(bisect.bisect_right(ts, t), 1), len(at) - 1)
        t0, t1 = ts[j - 1], ts[j]
        u0, u1 = placed[at[j - 1]], placed[at[j]]
        return u0 + (t - t0) * (u1 - u0) / max(t1 - t0, 1)
    return place


def _launched(host_ops, device_ops):
    """(the start of each launching host call, in order; the device time
    of the operations launched before each, summed, in us), or None
    where there are no device operations or the launches do not match
    them one for one."""
    launches = sorted(s for name, s, _ in host_ops
                      if name.startswith(LAUNCHES))
    ops = sorted((s, e) for _, s, e in device_ops)
    if not ops or len(launches) != len(ops):
        return None
    cum = [0.0]
    for s, e in ops:
        cum.append(cum[-1] + (e - s))
    return launches, cum


RECORDER = Recorder()
span = RECORDER.span
wait_span = RECORDER.wait_span
records = RECORDER.records


def spanned(name: str, attrs):
    """Decorate a function to run inside span `name`. `attrs(out, *args,
    **kwargs)` gives the attributes set at its end from its result and
    arguments, called only while recording."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            sp = span(name)
            if not sp:
                return fn(*args, **kwargs)
            with sp:
                out = fn(*args, **kwargs)
                sp.set(**attrs(out, *args, **kwargs))
            return out
        return inner
    return wrap

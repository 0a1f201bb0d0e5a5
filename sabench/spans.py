"""The program's own spans over a traced window, for the readers of
`layers/` whose source is `program_span` or `program_counter`.

The program records its spans itself while a profiler runs
(`stringsearch_torch/harness/tracing.py`), so the traced units of
`run.py:traced_window` are one recording session. `of(trace)` asks the
program's recorder, where the program loaded one, for that session's
spans on the trace's clock, each with the device time of the operations
it launched, which the recorder reads from the trace's own host and
device events. It gives none where the program records no spans (a
version before them, a control), and none whose markers the trace lacks,
so the spans of another session never reach a reader.

The rest is arithmetic on spans: anything with the fields `name`, `index`,
`parent`, `attrs`, `start_us`, `end_us` and `device_ms` will do, as the
tests' synthetic spans do.
"""

from __future__ import annotations

import sys

RECORDER = "stringsearch_torch.harness.tracing"
BUILD = "doubling.build"


def of(trace) -> list:
    """The program's spans of the traced window, on the trace's clock."""
    records = getattr(sys.modules.get(RECORDER), "records", None)
    if records is None:
        return []
    return records(trace.host_ops, trace.device_ops)


def builds(spans) -> int:
    """The number of builds the spans hold."""
    return sum(s.name == BUILD for s in spans)


def on_device(spans) -> bool:
    """True where the builds were timed on a device (their spans carry
    device times); a build that launched nothing on a device carries
    none."""
    return any(s.name == BUILD for s in spans) and all(
        s.device_ms is not None for s in spans if s.name == BUILD)


def device_ms(spans, *names) -> float:
    """The summed device time of the spans with one of `names` (a span
    that launched nothing adds 0)."""
    return sum(s.device_ms or 0.0 for s in spans if s.name in names)


def sort_bytes(attrs) -> int:
    """The bytes an `ops.device_sort` span's sort moves: each of its planes
    read and written once, 2 n sum(itemsizes) (`peaks.sort_bytes`)."""
    return 2 * attrs["n"] * sum(attrs["itemsizes"])


def plane_bytes(attrs) -> int:
    """The bytes a step's span says it reads and writes, each plane once
    (`peaks.pack_keys_bytes`, `shift_planes_bytes`, `head_ranks_bytes`)."""
    return sum(n * size for n, size in (*attrs["reads"], *attrs["writes"]))

"""The radix passes a build's full rounds run, from the program's own
reckoning: `live_passes` of each `doubling.round` span (the passes whose
digit is not constant over its key plane, as the sort's plan marks them),
summed over the traced window's rounds, over its builds. None where the
rounds carry no such attribute (a program that does not reckon them)."""

from sabench import spans

ROUND = "doubling.round"


def value(trace, records):
    if trace.kind != "build":
        return None
    builds = spans.builds(records)
    rounds = [s for s in records if s.name == ROUND]
    if not builds or any("live_passes" not in s.attrs for s in rounds):
        return None
    return sum(s.attrs["live_passes"] for s in rounds) / builds


def read(trace):
    return value(trace, spans.of(trace))

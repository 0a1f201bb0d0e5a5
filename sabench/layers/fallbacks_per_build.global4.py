"""The fast paths of a global build that fell back, a build: the
`global.build` spans' own counts (`fallbacks`, the distributed sorts'
routes that fell back to the merge-split sort, by cause, and
`compact_fallbacks`, the compacted rounds that fell back to a full-width
round), summed, over the `global.build` spans."""

from sabench import cards, spans


def value(trace, records):
    builds = [s for s in records if s.name == cards.BUILD]
    if trace.kind != "build" or not builds:
        return None
    return sum(sum(s.attrs["fallbacks"].values())
               + s.attrs["compact_fallbacks"] for s in builds) / len(builds)


def read(trace):
    return value(trace, spans.of(trace))

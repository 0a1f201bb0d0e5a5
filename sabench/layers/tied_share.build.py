"""The share of the round loop's sorting spent on suffixes still tied, in
%: the tied count going into each round's sort over the elements that
sort carried, summed over the full rounds (`doubling.round`: n elements)
and the compacted rounds (`doubling.compact_round`: capacity m), from the
program's own counts. The rest of what those sorts carried was resolved
already. None where no build ran a round."""

from sabench import spans

ROUNDS = {"doubling.round": "n", "doubling.compact_round": "m"}


def value(trace, records):
    if trace.kind != "build":
        return None
    rounds = [s for s in records if s.name in ROUNDS]
    if not rounds:
        return None
    tied = sum(s.attrs["tied_in"] for s in rounds)
    carried = sum(s.attrs[ROUNDS[s.name]] for s in rounds)
    return 100.0 * tied / carried


def read(trace):
    return value(trace, spans.of(trace))

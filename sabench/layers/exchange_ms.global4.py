"""Device time of the copies between cards a global build, in ms: every
copy between two cards in the traced window (`Memcpy PtoP`, each on its
source card's stream), on every card, over the `global.build` spans. That
is the collectives' copies (`coll.*`) and the placement of the shards on
their cards (`global.place`, about 2 card-ms of some 470 at 2^30 B). The
copies are summed by name, not paired with their spans: the profiler now
and then leaves one copy's record out of a four-card trace, which a
pairing cannot survive and a sum hardly notices."""

from sabench import cards, spans


def value(trace, records):
    if trace.kind != "build" or not trace.device_ops or not cards.builds(
            records):
        return None
    return cards.family_us(trace, cards.PEER_COPY.pattern) * 1e-3 / (
        cards.builds(records))


def read(trace):
    return value(trace, spans.of(trace))

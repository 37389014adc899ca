"""chunk.collect_ms: mean host time of ``ModemFarm.collect_bytes`` (its
wait for the card, the copies and the per-channel bytes) over the
run's steps."""


def read(rec):
    ms = rec.get("collect_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)

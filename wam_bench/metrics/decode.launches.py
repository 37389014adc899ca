"""decode.launches: kernel launches per soft decode, those of the
program's ``soft.dispatch`` span and of every span under it, over the
span's count in the traced window."""

from wam_bench import spans


def read(rec):
    s = spans.span(rec, "soft.dispatch")
    if s is None:
        return None
    t = rec["trace"]["spans"]
    return sum(t[n]["launches"] for n in spans.descendants(
        t, "soft.dispatch")) / s["count"]

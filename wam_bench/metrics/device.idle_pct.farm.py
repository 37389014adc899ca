"""device.idle_pct.farm: share (%) of the traced window in which no
kernel, copy or memset ran on the card."""

from wam_bench import trace


def read(rec):
    return trace.idle_pct(rec.get("trace"))

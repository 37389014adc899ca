"""decode.sync_device_ms: device time of what the program's
``soft.sync`` span launched (the sync correlation GEMM, its argmax and
gate) per decode in the traced window."""

from wam_bench import spans


def read(rec):
    s = spans.span(rec, "soft.sync")
    return None if s is None else 1e3 * s["device_s"] / s["count"]

"""decode.dispatch_ms: host time to enqueue one soft decode, the mean of
the program's ``soft.dispatch`` timer over the untraced part of the
window (``spans.untraced_timers``); the traced span's mean, which
carries the profiler's cost per op, is on its ``traced span:`` line."""

from wam_bench import spans


def read(rec):
    return spans.timer_ms(rec, "soft.dispatch")

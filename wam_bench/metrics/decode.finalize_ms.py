"""decode.finalize_ms: host time to build one batch's answers, the mean
of the program's ``soft.finalize`` timer less its event wait
(``soft.finalize.wait``), over the untraced part of the window
(``spans.untraced_timers``)."""

from wam_bench import spans


def read(rec):
    return spans.timer_ms(rec, "soft.finalize", less="soft.finalize.wait")

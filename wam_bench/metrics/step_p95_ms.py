"""step_p95_ms: the 95th percentile over every step completed in the
window of its host time from the dispatch call until its decoded bytes
are host objects."""

from wam_bench import stats


def read(rec):
    lat = rec.get("step_latency_s")
    if not lat:
        return None
    return 1e3 * stats.p95(lat)

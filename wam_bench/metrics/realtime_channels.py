"""realtime_channels: channels one card carries in real time, the sum
over the steps completed in the window of (channels decoded exact x the
step's audio seconds), over the window's seconds."""

from wam_bench import stats


def read(rec):
    work = rec.get("step_channel_audio_s")
    if not work:
        return None
    return stats.rate(work, rec["window_s"])

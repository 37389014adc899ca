"""chunk.device_ms: mean device time of ``demod_chunk`` (the call into
``ModemFarm.demodulate_chunk``), CUDA events around the call, over the
traced steps."""


def read(rec):
    ms = rec.get("chunk_device_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)

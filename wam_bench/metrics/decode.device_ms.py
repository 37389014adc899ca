"""decode.device_ms: device time of the kernels per soft decode
(``soft_fsk.decode_frames_batch_async``) in the traced window."""


def read(rec):
    t, n = rec.get("trace"), rec.get("decodes_traced")
    if not t or not n:
        return None
    return 1e3 * sum(s for _, s in t["kernels"].values()) / n

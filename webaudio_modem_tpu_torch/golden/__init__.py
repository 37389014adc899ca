"""The golden scalar comparator (numpy), the port's copy."""

from webaudio_modem_tpu_torch.golden.fsk_golden import GoldenFSK  # noqa: F401

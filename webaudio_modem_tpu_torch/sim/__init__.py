"""Channel simulators of the port (``webaudio_modem_tpu/sim``)."""

from webaudio_modem_tpu_torch.sim.channels import (  # noqa: F401
    awgn,
    awgn_snr,
    make_awgn_channel,
    make_chain,
    make_dc_offset,
    make_device_awgn,
    make_dropout_channel,
    make_gain,
    signal_power,
)

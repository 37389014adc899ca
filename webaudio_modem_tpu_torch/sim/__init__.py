"""Channel simulators, the BER harness and the impairment sweeps of the
port (``webaudio_modem_tpu/sim``)."""

from webaudio_modem_tpu_torch.sim.ber import (  # noqa: F401
    BERPoint,
    ber_parity_report,
    ber_sweep,
    bit_errors,
    golden_demodulate,
)
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
from webaudio_modem_tpu_torch.sim.impairments import (  # noqa: F401
    ImpairmentPoint,
    carrier_offset_sweep,
    clock_skew,
    clock_skew_sweep,
)

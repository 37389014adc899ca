"""XModem over a noisy FSK audio channel through the port's processor
and audio graph on the CPU: ``tests/runtime/test_integration.py``'s
noisy transfer (BASELINE config 3), noise ~30 dB below the tones."""

from torch_port_helpers import arq_transfer, make_arq_stack
from webaudio_modem_tpu_torch.sim import make_awgn_channel


class TestXModemOverAudio:
    async def test_transfer_over_noisy_channel(self):
        graph, sender, receiver = make_arq_stack(
            channel_fn=make_awgn_channel(noise_power=5e-4, seed=3))
        data = b"noisy channel payload"
        received = await arq_transfer(graph, sender, receiver, data)
        assert received == data
        assert sender.get_statistics().packets_retransmitted == 0

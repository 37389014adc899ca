"""XModem over DBPSK audio: ``tests/modems/test_psk.py``'s
``TestPSKOverTransport`` against the port, with ``PSKCore`` injected
into the processor (the plain versions of K6 and K2 on the CPU)."""

from torch_port_helpers import arq_transfer, make_arq_stack
from webaudio_modem_tpu_torch.models.psk import DEFAULT_PSK_CONFIG, PSKCore


class TestPSKOverTransport:
    async def test_xmodem_over_psk_audio(self):
        # the runtime and transport layers are modulation-agnostic
        graph, sender, receiver = make_arq_stack(
            core_factory=lambda: PSKCore(device="cpu"),
            config=DEFAULT_PSK_CONFIG)
        data = b"PSK over XModem!"
        received = await arq_transfer(graph, sender, receiver, data)
        assert received == data
        assert sender.get_statistics().packets_retransmitted == 0

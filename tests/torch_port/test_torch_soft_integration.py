"""XModem ARQ over the soft-FEC physical layer: the hello transfer of
``tests/runtime/test_soft_integration.py`` against the port, with
``SoftModemCore`` injected into the processor (the plain versions of K1
in its csum mode and K3 on the CPU).  That file's surface tests have
their port copies in ``test_torch_soft_modem.py``; its LDPC-body case
waits for the block codes (ROADMAP queue 1, item 14)."""

from torch_port_helpers import arq_transfer, make_arq_stack
from webaudio_modem_tpu_torch.models.soft_modem import SoftModemCore


class TestXModemOverSoftModem:
    async def test_hello_world_transfer(self):
        graph, sender, receiver = make_arq_stack(
            core_factory=lambda: SoftModemCore(device="cpu"))
        data = b"Hello, soft ARQ!"
        assert await arq_transfer(graph, sender, receiver, data) == data
        stats = sender.get_statistics()
        assert stats.bytes_transferred == len(data)
        assert stats.packets_retransmitted == 0

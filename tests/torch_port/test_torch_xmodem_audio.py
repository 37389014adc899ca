"""XModem over FSK audio through the port's processor and audio graph
on the CPU (the plain versions of K1 and K2): the hello transfer of
``tests/runtime/test_integration.py``, BASELINE config 3's short case.
The longer transfers of that suite (500 bytes, the CRC tail, 80 bytes,
the lossy channel) run on the card in ``chip_smoke.py`` phase 18."""

from torch_port_helpers import arq_transfer, make_arq_stack


class TestXModemOverAudio:
    async def test_hello_world_transfer(self):
        graph, sender, receiver = make_arq_stack()
        data = b"Hello, World!"
        received = await arq_transfer(graph, sender, receiver, data)
        assert received == data
        stats = sender.get_statistics()
        assert stats.bytes_transferred == len(data)
        assert stats.packets_retransmitted == 0
        assert receiver.get_statistics().packets_received == 1

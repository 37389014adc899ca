"""CPU smoke runs of the port's ``examples/demo.py``: a message over
XModem between two ``FSKProcessor`` stations on one ``AudioGraph``,
wrapped in a convolutional FEC frame (``--fec``: ``FrameEncoder`` out,
``FrameDecoder`` in) and over the soft-FEC physical layer (``--soft``:
``SoftModemCore``).  XModem waits 120 s: each quantum pays K1's plain
version."""

import asyncio

import pytest

from webaudio_modem_tpu_torch.examples import demo


@pytest.mark.parametrize("flag", ["--fec", "--soft"])
def test_demo_transfers_the_message(flag, capsys):
    rc = asyncio.run(demo.main([flag, "--message", "hi", "--device", "cpu",
                                "--timeout-ms", "120000"]))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "result: OK — 2 bytes" in out
    if flag == "--fec":
        assert "FEC framing: 2 B payload -> 20 B coded frame" in out


def test_demo_refuses_soft_with_fec():
    with pytest.raises(SystemExit):
        asyncio.run(demo.main(["--soft", "--fec", "--device", "cpu"]))

"""The generators: deterministic per seed, different across seeds, and
the same audio as the program's own transmitters."""

import numpy as np
import pytest
import torch

from wam_bench import harness
from wam_bench.reference import fec_fsk, uart_fsk
from wam_bench.traffic import gen_frames, gen_stream

CPU = torch.device("cpu")
HARD = harness.load_json("configs", "bell103_hard")
SOFT = harness.load_json("configs", "wam1200_softfec")
SEEDS = (2 ** 31 + 5, 2 ** 31 + 6)        # above 32 signed bits
SHORT_STREAM = dict(harness.load_json("traffic", "stream"),
                    cycle_seconds=2.0)
SMALL_FRAMES = dict(harness.load_json("traffic", "frames"), block=[16],
                    copies=1)


def _stream(seed):
    fsk = uart_fsk.Fsk.from_config(HARD["fsk"])
    return gen_stream.make(fsk, 3, 4800, SHORT_STREAM, seed, CPU)


def _frames(seed):
    fsk = uart_fsk.Fsk.from_config(SOFT["fsk"])
    return gen_frames.make(fsk, 3, SMALL_FRAMES, seed, CPU)


def test_stream_deterministic_per_seed_and_differs_across_seeds():
    a, b, c = _stream(SEEDS[0]), _stream(SEEDS[0]), _stream(SEEDS[1])
    assert torch.equal(a.audio, b.audio) and a.messages == b.messages
    assert not torch.equal(a.audio, c.audio) and a.messages != c.messages
    assert a.n_chunks == 20 and a.audio.shape == (3, 96000)


def test_stream_layout_bounds():
    fsk = uart_fsk.Fsk.from_config(HARD["fsk"])
    mix = harness.load_json("traffic", "stream")
    t = gen_stream.make(fsk, 64, 4800, mix, SEEDS[0], CPU)
    lengths = [len(m) for ms in t.messages for m in ms]
    assert min(lengths) >= 1 and max(lengths) <= 64
    assert 9 <= float(np.median(lengths)) <= 17      # median ~13
    assert all(ms for ms in t.messages)
    # the cycle ends in silence: the last 0.1 s is noise alone
    tail = t.audio[:, -4800:]
    assert float(tail.abs().max()) < 0.2


def test_stream_message_equals_program_modulator():
    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_mod
    from wam_bench.drivers import common

    fsk = uart_fsk.Fsk.from_config(HARD["fsk"])
    pay = torch.randint(0, 256, (3, 13), generator=torch.Generator()
                        .manual_seed(1)).to(torch.uint8)
    slots = uart_fsk.message_slots(fsk, pay)
    first = torch.full_like(slots, 2)
    ours = uart_fsk.synth_slots(fsk, slots,
                                uart_fsk.phase_acc(fsk, slots, first))
    params = FSKParams.from_config(common.program_config(HARD))
    theirs = fsk_mod.modulate_batch(params, [bytes(r) for r in pay.numpy()],
                                    "cpu")
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("length", [1, 16, 45, 133])
def test_frames_equal_program_synthesis(length):
    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import soft_fsk
    from wam_bench.drivers import common

    fsk = uart_fsk.Fsk.from_config(SOFT["fsk"])
    pay = torch.randint(0, 256, (2, length), generator=torch.Generator()
                        .manual_seed(length)).to(torch.uint8)
    ours = fec_fsk.synth_frames(fsk, pay)
    params = FSKParams.from_config(common.program_config(SOFT))
    theirs = soft_fsk.frames_synth_device_fn(params, length)(pay, "cpu")
    assert torch.equal(ours, theirs)
    assert ours.shape[1] == fec_fsk.frame_samples(fsk, length)


def test_frame_lengths_as_issued():
    fsk = uart_fsk.Fsk.from_config(SOFT["fsk"])
    assert [fec_fsk.frame_samples(fsk, n) for n in (16, 45, 133)] == \
        [16720, 35280, 91600]


def test_frames_deterministic_per_seed_and_differs_across_seeds():
    a, b, c = _frames(SEEDS[0]), _frames(SEEDS[0]), _frames(SEEDS[1])
    assert torch.equal(a.audio[(16, 0)], b.audio[(16, 0)])
    assert a.payloads == b.payloads and a.payloads != c.payloads
    assert not torch.equal(a.audio[(16, 0)], c.audio[(16, 0)])


def test_frames_order_same_mix_every_seed():
    mix = harness.load_json("traffic", "frames")
    orders = []
    for seed in SEEDS:
        t = gen_frames.FramesTraffic({}, {}, mix["block"], mix["copies"],
                                     seed)
        it = t.order()
        orders.append([next(it)[0] for _ in range(400)])
    for o in orders:
        for i in range(0, 400, 4):
            assert sorted(o[i:i + 4]) == sorted(mix["block"])
    assert orders[0] != orders[1]


def test_crc16_known_values():
    data = torch.tensor([list(b"123456789")], dtype=torch.uint8)
    assert int(fec_fsk.crc16_rows(data)[0]) == 0x29B1
    assert int(fec_fsk.crc16_rows(torch.tensor([[0xFF]], dtype=torch.uint8)
                                  )[0]) == 0xFF00

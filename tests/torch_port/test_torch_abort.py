"""Mirror of ``tests/utils/test_abort.py`` against the port.

AbortSignal / AbortController tests (DOM-semantics analog,
utils/abort.py — reference usage xmodem.ts:535-543,
fsk-processor.ts:26-61)."""

import asyncio

import pytest

from webaudio_modem_tpu_torch.utils.abort import (
    AbortController, AbortError, AbortSignal, race_abort)


async def test_controller_abort_sets_signal():
    c = AbortController()
    assert not c.signal.aborted
    c.abort("why")
    assert c.signal.aborted
    assert c.signal.reason == "why"


async def test_listeners_fire_once_synchronously():
    c = AbortController()
    fired = []
    c.signal.add_listener(lambda: fired.append(1))
    c.abort()
    c.abort()  # second abort is a no-op
    assert fired == [1]


async def test_listener_added_after_abort_fires_immediately():
    c = AbortController()
    c.abort()
    fired = []
    c.signal.add_listener(lambda: fired.append(1))
    assert fired == [1]


async def test_remove_listener():
    c = AbortController()
    fired = []
    cb = lambda: fired.append(1)  # noqa: E731
    c.signal.add_listener(cb)
    c.signal.remove_listener(cb)
    c.abort()
    assert fired == []


async def test_throw_if_aborted():
    c = AbortController()
    c.signal.throw_if_aborted()  # no-op
    c.abort()
    with pytest.raises(AbortError):
        c.signal.throw_if_aborted()


async def test_timeout_signal_fires():
    s = AbortSignal.timeout(20)
    assert not s.aborted
    await asyncio.sleep(0.05)
    assert s.aborted
    assert isinstance(s.reason, TimeoutError)


async def test_any_composition():
    a, b = AbortController(), AbortController()
    combined = AbortSignal.any([a.signal, b.signal])
    assert not combined.aborted
    b.abort("b-reason")
    assert combined.aborted
    assert combined.reason == "b-reason"


async def test_any_with_already_aborted_child():
    a = AbortController()
    a.abort()
    combined = AbortSignal.any([AbortController().signal, a.signal])
    assert combined.aborted


async def test_timeout_plus_external_composition():
    # the transport's composite (xmodem.ts:535-543)
    external = AbortController()
    combined = AbortSignal.any([AbortSignal.timeout(5000),
                                external.signal])
    external.abort()
    assert combined.aborted


async def test_race_abort_returns_result():
    async def work():
        return 42

    assert await race_abort(work(), AbortController().signal) == 42


async def test_race_abort_raises_on_abort():
    c = AbortController()

    async def hang():
        await asyncio.sleep(30)

    task = asyncio.ensure_future(race_abort(hang(), c.signal))
    await asyncio.sleep(0.01)
    c.abort()
    with pytest.raises(AbortError):
        await task


async def test_race_abort_pre_aborted():
    c = AbortController()
    c.abort()

    async def work():
        return 1

    coro = work()
    with pytest.raises(AbortError):
        await race_abort(coro, c.signal)
    coro.close()


def test_config_from_camel_case_dict():
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    cfg = FSKConfig.from_dict({
        "sampleRate": 44100, "baudRate": 300,
        "markFrequency": 1000, "spaceFrequency": 1200,
        "preamblePattern": [0xAA], "sfdPattern": [0x7E],
        "syncThreshold": 0.9, "agcEnabled": False,
    })
    assert cfg.sample_rate == 44100
    assert cfg.baud_rate == 300
    assert cfg.preamble_pattern == (0xAA,)
    assert not cfg.agc_enabled


def test_config_roundtrip_snake_case():
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    cfg = FSKConfig.from_dict({"baud_rate": 600})
    assert cfg.baud_rate == 600
    assert cfg.sample_rate == 48000  # defaults preserved

# -- timeout_any: the single-allocation per-wait composite ----------------


async def test_timeout_any_short_delay_fires():
    # sub-second delays take the plain call_later path
    s = AbortSignal.timeout_any(20, ())
    assert not s.aborted
    await asyncio.sleep(0.05)
    assert s.aborted
    assert isinstance(s.reason, TimeoutError)


async def test_timeout_any_wheel_path_fires():
    # >= 1 s delays go through the shared timer wheel (coarse buckets,
    # never early, at most one bucket late)
    s = AbortSignal.timeout_any(1000, ())
    assert not s.aborted
    await asyncio.sleep(0.95)
    assert not s.aborted          # never fires early
    await asyncio.sleep(0.3)
    assert s.aborted
    assert isinstance(s.reason, TimeoutError)


async def test_timeout_any_parent_abort_propagates():
    parent = AbortController()
    s = AbortSignal.timeout_any(30000, (parent.signal,))
    assert not s.aborted
    parent.abort("parent-reason")
    assert s.aborted
    assert s.reason == "parent-reason"


async def test_timeout_any_pre_aborted_parent():
    parent = AbortController()
    parent.abort("already")
    s = AbortSignal.timeout_any(30000, (parent.signal,))
    assert s.aborted
    assert s.reason == "already"


async def test_timeout_any_detach_cancels_timer_and_unhooks():
    parent = AbortController()
    s = AbortSignal.timeout_any(20, (parent.signal,))
    s.detach()
    await asyncio.sleep(0.05)
    assert not s.aborted          # detached: timeout no longer aborts
    parent.abort()
    assert not s.aborted          # parent listener removed
    assert parent.signal._listeners == []


async def test_timeout_any_wheel_detach_skipped_at_fire():
    s = AbortSignal.timeout_any(1000, ())
    s.detach()
    await asyncio.sleep(1.25)
    assert not s.aborted


def test_timeout_any_detach_drops_refs():
    """The timer wheel retains detached signals until their bucket's
    deadline (no unschedule, by design); detach must leave only a
    bare husk — no parent signals or waiter closures — so a farm
    run's retained window costs bytes, not object graphs."""
    import asyncio

    from webaudio_modem_tpu_torch.utils.abort import (AbortController,
                                                      AbortSignal)

    async def main():
        ext = AbortController()
        sig = AbortSignal.timeout_any(5000, [ext.signal])
        sig.add_listener(lambda: None)
        assert sig._parents
        sig.detach()
        assert sig._parents == ()
        assert not sig._listeners
        assert sig._handle is None
        assert not ext.signal._listeners     # unhooked from the parent
        # late wheel fire is a no-op on the husk
        sig._fire_timeout()
        assert not sig.aborted

    asyncio.run(main())

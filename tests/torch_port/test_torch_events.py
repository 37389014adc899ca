"""Mirror of ``tests/core/test_events.py`` against the port.

EventEmitter tests (reference tests/core.node.test.ts)."""

from webaudio_modem_tpu_torch.core import Event, EventEmitter


class Emitter(EventEmitter):
    pass


def test_on_emit():
    e = Emitter()
    got = []
    e.on("x", lambda ev: got.append(ev.data))
    e.emit("x", Event(42))
    assert got == [42]


def test_emit_default_event():
    e = Emitter()
    got = []
    e.on("x", lambda ev: got.append(ev.data))
    e.emit("x")
    assert got == [None]


def test_multiple_listeners_in_order():
    e = Emitter()
    got = []
    e.on("x", lambda ev: got.append(1))
    e.on("x", lambda ev: got.append(2))
    e.emit("x")
    assert got == [1, 2]


def test_off_removes_listener():
    e = Emitter()
    got = []

    def cb(ev):
        got.append(ev.data)

    e.on("x", cb)
    e.off("x", cb)
    e.emit("x", Event(1))
    assert got == []


def test_off_unknown_is_noop():
    e = Emitter()
    e.off("nope", lambda ev: None)


def test_remove_all_listeners_single_event():
    e = Emitter()
    got = []
    e.on("x", lambda ev: got.append("x"))
    e.on("y", lambda ev: got.append("y"))
    e.remove_all_listeners("x")
    e.emit("x")
    e.emit("y")
    assert got == ["y"]


def test_remove_all_listeners_all():
    e = Emitter()
    got = []
    e.on("x", lambda ev: got.append("x"))
    e.on("y", lambda ev: got.append("y"))
    e.remove_all_listeners()
    e.emit("x")
    e.emit("y")
    assert got == []


def test_listener_mutating_during_emit():
    e = Emitter()
    got = []

    def cb1(ev):
        got.append(1)
        e.off("x", cb2)

    def cb2(ev):
        got.append(2)

    e.on("x", cb1)
    e.on("x", cb2)
    e.emit("x")  # snapshot semantics: both fire this round
    assert got == [1, 2]
    e.emit("x")
    assert got == [1, 2, 1]

"""The port's interaction styles (``core.styles``), mTMS mapping
(``navigation.mtms``) and pedals (``net.pedal_connection``) against the JAX
package's on the same inputs (the JAX tests: tests/test_editor_ops.py:100,
tests/test_navigation.py:714-788, tests/test_aux_subsystems.py:86).  mido
and the mTMS transport are faked; nothing touches a device."""

import random
import sys
import time
import types

import numpy as np
import pytest

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core import styles as styles_jax
from invesalius3_tpu.navigation import mtms as mtms_jax
from invesalius3_tpu.net import pedal_connection as pedal_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.core import styles
from invesalius3_tpu_torch.navigation import mtms
from invesalius3_tpu_torch.net import pedal_connection as pedal

# --------------------------------------------------------------------------
# styles
# --------------------------------------------------------------------------

STATES = [n for n in dir(styles) if n.startswith(("STATE_", "SLICE_STATE_", "VOLUME_STATE_"))]


def test_style_constants_equal_the_jax_package():
    assert STATES == [n for n in dir(styles_jax)
                      if n.startswith(("STATE_", "SLICE_STATE_", "VOLUME_STATE_"))]
    assert all(getattr(styles, n) == getattr(styles_jax, n) for n in STATES)
    assert styles.STYLE_LEVELS == styles_jax.STYLE_LEVELS


def test_style_state_manager_follows_the_jax_package():
    rng = np.random.default_rng(0)
    ops = [(bool(rng.integers(2)), getattr(styles, STATES[i]))
           for i in rng.integers(0, len(STATES), 200)]
    ops += [(True, "unlisted tool"), (False, "unlisted tool"), (False, styles.STATE_DEFAULT)]
    heard = []
    bus = events.Publisher()
    bus.subscribe(lambda state: heard.append(state), "styles.changed")
    sm, sm_j = styles.StyleStateManager(bus=bus), styles_jax.StyleStateManager(
        bus=events_jax.Publisher())
    assert sm.current == styles.STATE_DEFAULT
    trail = []
    for add, state in ops:
        got = sm.add_state(state) if add else sm.remove_state(state)
        want = sm_j.add_state(state) if add else sm_j.remove_state(state)
        assert got == want == sm.current
        assert sm._stack == sm_j._stack
        trail.append(got)
    assert heard == trail


# --------------------------------------------------------------------------
# mTMS
# --------------------------------------------------------------------------

def _write_pp_file(path, offsets):
    lines = [f"# header {i}" for i in range(18)]
    lines += ["_".join(str(int(x)) for x in off) + "\tcap1\tcap2" for off in offsets]
    path.write_text("\n".join(lines) + "\n")


def test_relative_distance_and_offsets():
    rng = np.random.default_rng(1)
    for _ in range(50):
        t = np.r_[rng.uniform(-50, 50, 3), rng.uniform(-180, 180, 3)]
        c = t + np.r_[rng.uniform(-5, 5, 3), rng.uniform(-30, 30, 3)]
        got, want = mtms.compute_relative_distance(t, c), mtms_jax.compute_relative_distance(t, c)
        np.testing.assert_array_equal(got, want)
        assert mtms.offset_from_distance(got) == mtms_jax.offset_from_distance(want)
    assert mtms.offset_from_distance([2.4, -1.6, 0, 0, 0, 22.4]) == (2, 2, 15)
    assert mtms.offset_from_distance([-3.0, 1.2, 0, 0, 0, 0.0]) == (-1, -3, 0)


def _mtms_run(mod, bus, pp, tmp_path):
    fired = []
    m = mod.MTMS(bus=bus, parameter_file=pp, device=lambda row, i: fired.append((row, i)))
    coil = [10.0, 20.0, 30.0, 0.0, 0.0, 0.0]
    out = {"keys": list(m.keys), "available": m.available,
           "offset": m.get_offset(coil, [11.0, 22.0, 30.0, 0, 0, 0]),
           "find": m.find_parameters((1, 1, 0)), "miss": m.find_parameters((9, 9, 9)),
           "fire": m.update_target(coil, [11.0, 22.0, 30.0, 0, 0, 0]),
           "far": m.update_target(coil, [60.0, 20.0, 30.0, 0, 0, 0]),
           "check": m.check_targets(coil, [[11.0, 21.0, 30.0, 0, 0, 0]])}
    sleeps = []
    out["seq"] = m.update_target_sequence(
        coil, [[11.0, 21.0, 30.0, 0, 0, 0], [9.0, 19.0, 30.0, 0, 0, 0]],
        number_of_stim=2, rng=random.Random(0), sleep=sleeps.append)
    out["empty"] = m.update_target_sequence(coil, [])
    out.update(fired=fired, sleeps=sleeps, log=m.sequence_log,
               offsets=m.get_offsets([1, 2, 3, 0, 0, 10], [0, 0, 0, 0, 0, 4]))
    rows = m.save_sequence(tmp_path).read_text().splitlines()
    out["csv"] = rows
    return out


def test_mtms_equals_the_jax_package(tmp_path):
    pp = tmp_path / "pp.txt"
    _write_pp_file(pp, [(x, y, r) for x in range(-3, 4) for y in range(-3, 4)
                        for r in (-15, 0, 15)])
    heard = []
    bus = events.Publisher()
    bus.subscribe(events.wants_topic(lambda topic=None, **kw: heard.append(topic)),
                  events.ALL_TOPICS)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _mtms_run(mtms, bus, pp, tmp_path / "port")
    want = _mtms_run(mtms_jax, events_jax.Publisher(), pp, tmp_path / "jax")
    assert got == want
    assert got["fire"] and not got["far"] and got["seq"] and len(got["fired"]) == 5
    assert all(3.0 <= s < 5.0 for s in got["sleeps"])
    assert got["csv"][0].split("\t") == ["mTMS_target", "brain_target(nav)",
                                         "coil_pose(nav)", "intensity"]
    assert heard.count("mtms.pulse_sent") == 5 and "mtms.invalid_target" in heard


def test_mtms_without_a_transport_publishes_only(tmp_path):
    pp = tmp_path / "pp.txt"
    _write_pp_file(pp, [(0, 0, 0)])
    heard = []
    bus = events.Publisher()
    bus.subscribe(events.wants_topic(lambda topic=None, **kw: heard.append((topic, kw))),
                  events.ALL_TOPICS)
    m = mtms.MTMS(bus=bus, parameter_file=pp)
    assert not m.available and m.load_parameter_file(pp) == 1
    assert m.update_target([0.0] * 6, [0.2, 0.1, 0, 0, 0, 0])
    assert heard == [("mtms.unavailable", {}),
                     ("mtms.pulse_sent", {"row": 1, "intensity": 20.0})]


# --------------------------------------------------------------------------
# pedal
# --------------------------------------------------------------------------

def _press_sequence(mod):
    pc = mod.PedalConnector()
    presses = []
    pc.add_callback("capture", lambda s: presses.append(("capture", s)),
                    remove_when_released=True)
    pc.add_callback("mark", lambda s: presses.append(("mark", s)))
    pc.programmatic.press()
    pc.programmatic.release()
    pc.programmatic.press()
    pc.remove_callback("mark")
    pc.programmatic.release()
    return presses


def test_pedal_connector_equals_the_jax_package():
    assert _press_sequence(pedal) == _press_sequence(pedal_jax) == [
        ("capture", True), ("mark", True), ("capture", False), ("mark", False),
        ("mark", True)]


def test_api_pedal_joins_the_connector():
    class Api:
        def __init__(self):
            self.names = []

        def add_pedal_callback(self, name, cb, remove_when_released=False):
            self.names.append(name)

        def add_callback(self, name, cb, remove_when_released=False):
            self.add_pedal_callback(name, cb, remove_when_released)

        def remove_callback(self, name):
            self.names.remove(name)

    api = Api()
    pc = pedal.PedalConnector(api=api)
    pc.add_callback("x", lambda s: None)
    assert api.names == ["x"] and len(pc.pedals) == 2
    pc.remove_callback("x")
    assert api.names == []


def test_midi_pedal_without_mido_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "mido", None)
    for mod in (pedal, pedal_jax):
        with pytest.raises(RuntimeError, match="mido") as exc:
            mod.MidiPedal()
        assert isinstance(exc.value.__cause__, ImportError)


def _fake_mido(names, messages):
    class Port:
        def __init__(self):
            self.sent = list(messages)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def iter_pending(self):
            out, self.sent = self.sent, []
            return iter(out)

    return types.SimpleNamespace(get_input_names=lambda: list(names),
                                 open_input=lambda name: Port())


def test_midi_pedal_dispatches_note_messages(monkeypatch):
    msgs = [types.SimpleNamespace(type=t) for t in ("note_on", "control_change", "note_off")]
    monkeypatch.setitem(sys.modules, "mido", _fake_mido(["p0"], msgs))
    seen = []
    p = pedal.MidiPedal()
    p.add_callback("cb", seen.append)
    deadline = time.monotonic() + 5
    while len(seen) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    p.stop()
    p._thread.join(5)
    # the messages may be read before the callback is registered: then none
    assert seen in ([True, False], [])
    assert p.port_name == "p0" and not p._thread.is_alive()
    monkeypatch.setitem(sys.modules, "mido", _fake_mido([], []))
    with pytest.raises(RuntimeError, match="no MIDI input ports"):
        pedal.MidiPedal()

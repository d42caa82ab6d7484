"""``chip_smoke.py`` phase [16] (``network_and_trackers_phase``) rehearsed on
the CPU at a small size: a C-MOVE of a 32-slice study (beside an 8-slice
series) from the mini-PACS through the port's server to its watershed and
frames, the four hardware trackers' replays feeding Navigation sessions
with the e-field worker behind ``NeuronavigationApi`` and the TTL port, the
grids on a 48^3 phantom's scalp, and ``app.main --remote-host``.  Every
check of the phase holds (it raises otherwise) but the launch counts,
which hold on the card only."""

import torch

import chip_smoke
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.net import download

torch.set_num_threads(2)


def _refuse(url, *a, **kw):
    raise OSError(f"the tests fetch nothing ({url})")


def test_network_and_trackers_phase_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.delenv("INV3_LANGUAGE", raising=False)
    monkeypatch.setattr(download, "download_url_to_file", _refuse)
    out = chip_smoke.network_and_trackers_phase(
        torch.device("cpu"), tmp_path, n=32, second=8, poses=60, tracker_s=0.6, grid_n=48,
        mirror_s=0.6, fod_shape=(30, 34, 30), roi_n=1000, tracts=(8, 20), reps=1,
        scene_hz_14=50.0)
    assert out["pacs"]["move_ms"] > out["pacs"]["transfer_ms"] > 0
    assert set(out["trackers"]) == set(chip_smoke.NET_HARDWARE)
    assert all(t["reads"] > 0 and t["solver_calls"] > 0 for t in out["trackers"].values())
    assert out["grid"]["verts"] > 1000 and out["mirror"]["topics"] >= 2
    assert events.bus._hook is None
    assert events.bus.add_send_message_hook.__func__ is events.Publisher.add_send_message_hook

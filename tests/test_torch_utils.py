"""The port's utils (``invesalius3_tpu_torch.utils``: helpers, logging,
paths, errors, plugins, i18n) against the JAX package's on the same inputs
(the JAX tests: tests/test_aux_subsystems.py:14-73, :229, :396, :494-538).
Every test writes under a temporary ``XDG_CONFIG_HOME``; the update check's
``urlopen`` is stubbed, so nothing is fetched."""

import io
import json
import logging
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.utils import errors as errors_jax
from invesalius3_tpu.utils import helpers as helpers_jax
from invesalius3_tpu.utils import i18n as i18n_jax
from invesalius3_tpu.utils import logging as ilog_jax
from invesalius3_tpu.utils import paths as paths_jax
from invesalius3_tpu.utils import plugins as plugins_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.utils import errors, helpers, i18n, paths, plugins
from invesalius3_tpu_torch.utils import logging as ilog

PORT = Path(__file__).resolve().parent.parent / "invesalius3_tpu_torch"


@pytest.fixture(autouse=True)
def config_home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.delenv("INV3_LANGUAGE", raising=False)
    yield
    i18n.install_language("en")
    i18n_jax.install_language("en")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

NAMES = [("Mask 1", []), ("Mask 1", ["Mask 1 copy"]), ("Mask 1 copy", ["Mask 1 copy"]),
         ("Mask 1 copy#2", ["Mask 1 copy", "Mask 1 copy#2"]),
         ("Mask 1", ["Mask 1 copy", "Mask 1 copy#1"])]


@pytest.mark.parametrize("name,existing", NAMES)
def test_next_copy_name_equals_the_jax_package(name, existing):
    assert helpers.next_copy_name(name, existing) == helpers_jax.next_copy_name(name, existing)


def test_singleton_two_ways_dictionary_and_timing():
    class S(metaclass=helpers.Singleton):
        pass

    assert S() is S()
    items = {"a": 1, "b": 2, "c": 1}
    d, dj = helpers.TwoWaysDictionary(items), helpers_jax.TwoWaysDictionary(items)
    for v in (1, 2, 3):
        assert d.get_key(v) == dj.get_key(v) and d.get_keys(v) == dj.get_keys(v)
    assert d.get_value("b") == dj.get_value("b") == 2
    d.remove("zz")
    d.remove("a")
    assert d.get_keys(1) == ["c"]

    @helpers.timing
    def f(x):
        return x + 1

    assert f.last_seconds is None and f(1) == 2 and f.last_seconds >= 0.0
    assert f.__name__ == "f"


# --------------------------------------------------------------------------
# logging
# --------------------------------------------------------------------------

def _log_both(tmp_path):
    out = []
    for mod, sub in ((ilog, "port"), (ilog_jax, "jax")):
        mod.setup_logging(level=logging.DEBUG, log_dir=tmp_path / sub, console=False)
        mod.get_logger().info("hello")
        mod.get_logger("io").debug("reading slices")
        mod.get_logger("io").warning("bad header in file_7")
        mod.get_logger("perf").info("[PERF] stageX: 0.1s")
        out.append(mod)
    return out


@pytest.mark.parametrize("kw", [{}, {"level": "WARNING"}, {"component": "perf"},
                                {"search": "FILE_7"}, {"limit": 2},
                                {"level": "nonsense"}])
def test_query_log_equals_the_jax_package(tmp_path, kw):
    _log_both(tmp_path)
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in ilog.query_log(**kw)]
    want = [{k: v for k, v in e.items() if k != "ts"} for e in ilog_jax.query_log(**kw)]
    assert strip == want and strip


def test_ring_file_spans_and_report(tmp_path):
    ilog.setup_logging(level=logging.DEBUG, log_dir=tmp_path, console=False)
    ilog.get_logger().info("hello")
    with ilog.trace(tmp_path / "trace"):  # spans are traced while a profiler records
        with ilog.span("stage1"):
            pass
    lines = ilog.recent_log_lines()
    assert any("hello" in ln for ln in lines)
    assert any("[PERF] stage1" in ln for ln in lines)
    assert lines == ilog._memory_handler.dump()
    assert ilog.perf_report()[-1]["name"] == "stage1"
    assert (tmp_path / "invesalius3_tpu_torch.log").read_text().count("hello") == 1

    @ilog.timing
    def work(x):
        return x * 2

    with ilog.trace(tmp_path / "trace"):
        assert work(3) == 6
    assert ilog.perf_report()[-1]["name"].endswith("work")
    ilog.export_perf_report(tmp_path / "perf.json")
    assert json.loads((tmp_path / "perf.json").read_text())[-1]["name"].endswith("work")


def test_trace_writes_a_chrome_trace(tmp_path):
    with ilog.trace(tmp_path / "trace"):
        torch.ones(8).sum()
    (out,) = (tmp_path / "trace").glob("*.json")
    assert "traceEvents" in json.loads(out.read_text())


# --------------------------------------------------------------------------
# paths
# --------------------------------------------------------------------------

def test_paths_are_the_ports_own(tmp_path):
    names = ["user_log_dir", "user_presets_dir", "user_plugins_dir", "models_dir"]
    for n in names:
        got, want = getattr(paths, n)(), getattr(paths_jax, n)()
        assert got.relative_to(paths.user_dir()) == want.relative_to(paths_jax.user_dir())
    assert paths.user_dir() == tmp_path / "config" / "invesalius3_tpu_torch"
    paths.create_conf_folders()
    assert all(getattr(paths, n)().is_dir() for n in names)


def test_check_for_updates_fetches_nothing(monkeypatch):
    import urllib.request

    asked = []

    def fake_urlopen(url, timeout=None):
        asked.append((url, timeout))
        return io.BytesIO(b'{"tag_name": "v3.1.99999"}')

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    assert paths.check_for_updates("0.1.0") == "v3.1.99999"
    assert asked == [(paths.RELEASES_URL, 3.0)]

    def offline(url, timeout=None):
        raise OSError("offline")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    assert paths.check_for_updates("0.1.0") is None


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

def test_error_taxonomy_equals_the_jax_package():
    assert [c.value for c in errors.ErrorCategory] == [c.value for c in errors_jax.ErrorCategory]
    assert [s.value for s in errors.ErrorSeverity] == [s.value for s in errors_jax.ErrorSeverity]
    for name in ("FileIOError", "DicomReadError", "SegmentationError", "SurfaceError",
                 "NavigationError", "NetworkError", "DeviceError", "ProjectError"):
        cls, cls_j = getattr(errors, name), getattr(errors_jax, name)
        assert cls.category.value == cls_j.category.value
        assert cls.severity.value == cls_j.severity.value
        assert issubclass(cls, errors.InVesaliusError)


@pytest.mark.parametrize("reraise", [False, True])
def test_handle_errors_logs_and_reraises(reraise):
    ilog.setup_logging(console=False)

    @errors.handle_errors(errors.ErrorCategory.SEGMENTATION, reraise=reraise, default=-1)
    def boom():
        raise errors.SegmentationError("bad seed", {"seed": (1, 2, 3)})

    if reraise:
        with pytest.raises(errors.SegmentationError) as exc:
            boom()
        assert exc.value.details == {"seed": (1, 2, 3)}
    else:
        assert boom() == -1
    (e,) = ilog.query_log(component="errors")
    assert e["level"] == "ERROR" and "[segmentation]" in e["message"]


def test_crash_report_names_torch_and_no_card(tmp_path):
    try:
        raise errors.DicomReadError("broken file")
    except errors.InVesaliusError:
        path = errors.generate_crash_report(*sys.exc_info(), out_dir=tmp_path)
    try:
        raise errors_jax.DicomReadError("broken file")
    except errors_jax.InVesaliusError:
        path_j = errors_jax.generate_crash_report(*sys.exc_info(), out_dir=tmp_path / "jax")
    rep, rep_j = json.loads(path.read_text()), json.loads(path_j.read_text())
    assert rep["category"] == rep_j["category"] == "dicom"
    assert rep["exception"] == rep_j["exception"] and "broken file" in rep["exception"]
    assert "DicomReadError" in rep["traceback"]
    assert rep["system"]["torch"] == torch.__version__
    assert rep["system"]["cuda"] == torch.version.cuda
    assert rep["system"]["devices"] == []  # no card here
    assert "jax" not in rep["system"]


def test_crash_report_default_dir_and_hook(tmp_path, monkeypatch):
    try:
        raise ValueError("x")
    except ValueError:
        path = errors.generate_crash_report(*sys.exc_info())
    assert path.parent == paths.user_dir() / "crash"
    assert json.loads(path.read_text())["category"] == "unknown"
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(sys, "__excepthook__", lambda *a: None)
    errors.install_global_exception_handler(tmp_path / "hook")
    try:
        raise errors.NetworkError("down")
    except errors.NetworkError:
        sys.excepthook(*sys.exc_info())
    (rep,) = (tmp_path / "hook").glob("crash_*.json")
    assert json.loads(rep.read_text())["category"] == "network"


# --------------------------------------------------------------------------
# plugins
# --------------------------------------------------------------------------

def _plugin_dir(root: Path) -> Path:
    for name, enable in (("alpha", True), ("beta", False)):
        d = root / "plugins" / name
        d.mkdir(parents=True)
        (d / "plugin.json").write_text(json.dumps({"name": name, "enable": enable,
                                                   "description": name.upper()}))
        (d / "__init__.py").write_text("loaded = []\n\ndef load():\n    loaded.append(1)\n")
    bad = root / "plugins" / "broken"
    bad.mkdir()
    (bad / "plugin.json").write_text("{not json")
    return root / "plugins"


def test_plugin_manager_equals_the_jax_package(tmp_path):
    pdir = _plugin_dir(tmp_path)
    bus, bus_j = events.Publisher(), events_jax.Publisher()
    heard = []
    bus.subscribe(events.wants_topic(lambda topic=None, **kw: heard.append((topic, kw))),
                  events.ALL_TOPICS)
    pm = plugins.PluginManager(extra_dirs=[pdir], bus=bus)
    pm_j = plugins_jax.PluginManager(extra_dirs=[pdir], bus=bus_j)
    found, found_j = pm.find_plugins(), pm_j.find_plugins()
    assert found == found_j and sorted(found) == ["alpha", "beta"]
    assert pm.dirs[0] == paths.user_plugins_dir()
    pm.load_all_enabled()
    mod = sys.modules["invesalius3_tpu_torch_plugin_alpha"]
    assert mod.loaded == [1] and "invesalius3_tpu_torch_plugin_beta" not in sys.modules
    assert heard == [("plugins.found", {"names": ["alpha", "beta"]}),
                     ("plugins.loaded", {"name": "alpha"})]


# --------------------------------------------------------------------------
# i18n
# --------------------------------------------------------------------------

def test_locales_and_catalogs_equal_the_jax_package():
    assert i18n.get_locales() == i18n_jax.get_locales()
    assert {"pt_BR", "es", "de"} <= set(i18n.get_locales()) and len(i18n.get_locales()) == 24
    for lang in i18n.get_locales():
        assert i18n.current_catalog(lang) == i18n_jax.current_catalog(lang), lang
    assert i18n.current_catalog("xx_XX") == i18n_jax.current_catalog("xx_XX") == {}


@pytest.mark.parametrize("lang,msg", [
    ("pt_BR", "saved {path}"), ("es", "threshold [{tmin}, {tmax}]: {n} voxels"),
    ("fr", "saved {path}"), ("de", "not found"), ("ja", "volume: {shape} {dtype} spacing={spacing}"),
    ("pt", "no current mask"), ("nope", "saved {path}"), ("en", "saved {path}")])
def test_install_language_equals_the_jax_package(lang, msg):
    got, want = i18n.install_language(lang)(msg), i18n_jax.install_language(lang)(msg)
    assert got == want
    assert i18n.tr(msg) == got
    if lang in ("nope", "en"):
        assert got == msg  # the identity


def test_tr_follows_the_language_and_stays_english_by_default(monkeypatch):
    i18n.install_language("")
    assert i18n.current_language() == "en"  # the C locale here
    assert i18n.tr("saved {path}") == "saved {path}"
    monkeypatch.setenv("INV3_LANGUAGE", "pt_BR")
    assert i18n.current_language() == i18n_jax.current_language() == "pt_BR"
    i18n.install_language()
    assert i18n.tr("saved {path}") == "salvo {path}"


def test_compile_po_to_mo_writes_the_shipped_catalog(tmp_path):
    for lang in ("de", "pt_BR", "zh_TW"):
        po = PORT / "locale" / lang / "LC_MESSAGES" / "invesalius3_tpu.po"
        i18n.compile_po_to_mo(po, tmp_path / lang / "a.mo")
        i18n_jax.compile_po_to_mo(po, tmp_path / lang / "b.mo")
        got = (tmp_path / lang / "a.mo").read_bytes()
        assert got == (tmp_path / lang / "b.mo").read_bytes() == po.with_suffix(".mo").read_bytes()


def test_parse_po_equals_the_jax_package():
    text = ('msgid ""\nmsgstr "Content-Type: text/plain; charset=UTF-8\\n"\n\n'
            '# a comment\nmsgid "a"\nmsgstr "b"\n\nmsgid "long "\n"id"\nmsgstr ""\n'
            '"x\\ty"\n\nmsgid "untranslated"\nmsgstr ""\n')
    assert i18n.parse_po(text) == i18n_jax.parse_po(text)
    assert i18n.parse_po(text)["long id"] == "x\ty"


def test_every_message_of_the_port_is_in_every_catalog():
    """Every tr("...") literal of the port is translated in every shipped
    language (en is the identity), as the JAX package's coverage test holds
    its own."""
    msgids = set()
    for py in PORT.rglob("*.py"):
        src = py.read_text(encoding="utf-8")
        msgids |= set(re.findall(r'(?<![\w.])tr\(\s*"((?:[^"\\]|\\.)*)"\s*\)', src))
        for m in re.finditer(r'(?<![\w.])tr\(("(?:[^"\\]|\\.)*"(?:\s*"(?:[^"\\]|\\.)*")+)\s*\)',
                             src):
            msgids.add("".join(re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1))))
    assert len(msgids) >= 20
    for lang in i18n.get_locales():
        if lang == "en":
            continue
        cat = i18n.current_catalog(lang)
        missing = sorted(m for m in msgids if not cat.get(m))
        assert not missing, f"{lang} lacks {missing[:3]}"


# --------------------------------------------------------------------------
# console
# --------------------------------------------------------------------------

def test_console_context_and_main(tmp_path, monkeypatch):
    """The console binds the JAX console's names (and torch, the device),
    with the volume on the device asked for; it needs the card unless
    told "cpu"."""
    import code

    from invesalius3_tpu import console as console_jax
    from invesalius3_tpu.io.nifti import write_nifti
    from invesalius3_tpu_torch import console

    p = tmp_path / "v.nii"
    write_nifti(p, np.arange(4 * 5 * 6, dtype=np.int16).reshape(4, 5, 6))
    ctx = console.make_context(str(p), device="cpu")
    want = console_jax.make_context(str(p))
    assert set(ctx) == set(want) | {"torch", "device"}
    assert sorted(ctx["ops"]) == sorted(want["ops"])
    assert ctx["volume"].shape == (4, 5, 6) and ctx["volume"].device.type == "cpu"
    np.testing.assert_array_equal(ctx["slc"].matrix.numpy(), np.asarray(want["slc"].matrix))
    seen = []
    monkeypatch.setattr(code, "interact", lambda banner="", local=None: seen.append(
        (banner, sorted(local))))
    assert console.main([str(p)], device="cpu") == 0
    assert seen[0][0].startswith("invesalius3_tpu_torch interactive console")
    assert seen[0][1] == sorted(ctx)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            console.make_context()

"""The port stands alone: no module of ``invesalius3_tpu_torch`` and none of
``chip_smoke.py``, ``time_rays.py`` and ``time_viewer.py`` imports ``jax`` or
the JAX package ``invesalius3_tpu``,
and every native source the port builds lies inside the port's package."""

import ast
from pathlib import Path

import pytest

from invesalius3_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "invesalius3_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "invesalius3_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "time_rays.py",
                                         ROOT / "time_viewer.py"]


def _imported_top_names(path: Path):
    """(line, top-level package name) of every import in a module; relative
    imports stay inside the package they are in."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [(line, name) for line, name in _imported_top_names(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_tells_the_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import invesalius3_tpu_torch.ops\n"
                   "from invesalius3_tpu_torch import pipeline\n"
                   "from invesalius3_tpu.ops import watershed\n"
                   "import jax.numpy as jnp\n")
    names = [n for _, n in _imported_top_names(src)]
    assert names == ["invesalius3_tpu_torch", "invesalius3_tpu_torch",
                     "invesalius3_tpu", "jax"]
    assert [n for n in names if n in FORBIDDEN] == ["invesalius3_tpu", "jax"]


@pytest.mark.parametrize("lib", sorted(_build.LIBS))
def test_native_sources_are_the_ports_own(lib):
    for src in _build.LIBS[lib].sources:
        path = Path(src).resolve()
        assert path.is_relative_to(PORT), f"{lib} builds {path}"
        assert path.is_file()


NEW_MODULES = ["server.py", "console.py", "core/measures.py", "core/styles.py",
               "navigation/mtms.py", "net/pedal_connection.py", "utils/errors.py",
               "utils/helpers.py", "utils/i18n.py", "utils/logging.py",
               "utils/paths.py", "utils/plugins.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_the_scan_covers_the_viewer_server_slice(rel):
    path = PORT / rel
    assert path in SOURCES, rel
    assert not [n for _, n in _imported_top_names(path) if n in FORBIDDEN]


def test_server_and_catalogs_read_only_the_ports_files():
    """The server serves the port's own viewer copy, and the translations
    are looked up only in the port's own locale directory."""
    from invesalius3_tpu_torch import server
    from invesalius3_tpu_torch.utils import i18n

    assert server.VIEWER_ROOT.resolve().is_relative_to(PORT)
    for name in ("index.html", "app.js", "style.css"):
        assert (server.VIEWER_ROOT / name).is_file()
    dirs = i18n.locale_dirs()
    assert dirs and all(d.resolve().is_relative_to(PORT) for d in dirs)
    assert len(list(dirs[0].glob("*/LC_MESSAGES/invesalius3_tpu.po"))) == 24
    assert len(list(dirs[0].glob("*/LC_MESSAGES/invesalius3_tpu.mo"))) == 24


NETWORK_MODULES = ["net/dicom_net.py", "net/neuronavigation_api.py", "net/remote_control.py",
                   "net/remote_server.py", "navigation/vendor_coords.py",
                   "navigation/serial_port.py", "navigation/serial_drivers.py",
                   "navigation/grid.py"]


@pytest.mark.parametrize("rel", NETWORK_MODULES)
def test_the_scan_covers_the_network_slice(rel):
    path = PORT / rel
    assert path in SOURCES, rel
    assert not [n for _, n in _imported_top_names(path) if n in FORBIDDEN]


def test_the_scan_sees_imports_inside_functions(tmp_path):
    """``DicomNet.RunCFind`` imports the DICOM parser inside the function:
    the scan finds that import (the port's own ``io/dicom``), and would
    flag the JAX package's there."""
    src = (PORT / "net/dicom_net.py").read_text()
    run_cfind = next(n for n in ast.walk(ast.parse(src))
                     if isinstance(n, ast.FunctionDef) and n.name == "RunCFind")
    lazy = [n.module for n in ast.walk(run_cfind) if isinstance(n, ast.ImportFrom)]
    assert lazy == ["invesalius3_tpu_torch.io.dicom"]
    bad = tmp_path / "dicom_net.py"
    bad.write_text(src.replace("from invesalius3_tpu_torch.io.dicom import",
                               "from invesalius3_tpu.io.dicom import"))
    assert [n for _, n in _imported_top_names(bad) if n in FORBIDDEN] == ["invesalius3_tpu"]


PARALLEL_MODULES = ["parallel/__init__.py", "parallel/mesh_utils.py",
                    "parallel/distributed.py", "parallel/sharded_ops.py"]


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_the_scan_covers_the_parallel_slice(rel):
    path = PORT / rel
    assert path in SOURCES, rel
    assert not [n for _, n in _imported_top_names(path) if n in FORBIDDEN]


def test_only_parallel_is_left_to_port():
    """Nothing is left to port: every JAX module has a counterpart of the
    same path in the port (``parallel/`` since the shard-list slice) but
    the Pallas kernels (the CUDA sources in ``csrc/``) and ``native/``
    (``native.py`` and ``csrc/``)."""
    jax_pkg = ROOT / "invesalius3_tpu"
    missing = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
                     if not (PORT / p.relative_to(jax_pkg)).is_file())
    assert missing == ["native/__init__.py", "ops/pallas_kernels.py"]
    assert (PORT / "native.py").is_file()
    assert {"watershed_sweep.cu", "ray_projections.cu"} <= {p.name for p in (PORT / "csrc").iterdir()}

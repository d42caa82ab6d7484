"""Model-weight download with sha256 verification and progress (port of
invesalius3_tpu/net/download.py).

Reference: invesalius/net/utils.py ``download_url_to_file`` (+ the weight
auto-download in segment.py:404-440: weights fetched from
github.com/invesalius/weights into the ai/ dir keyed by sha256).

Weights are looked up under ``models_dir()/<name>/<filename>`` first; a
download is tried only for a file that is not there and has a URL.  The
FastSurfer views have no URL (the reference ships them with its installer),
so they are found on disk or not at all.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Callable, Optional

from invesalius3_tpu_torch.utils.paths import models_dir

# reference weight registry (segment.py: model name -> filename + sha256)
WEIGHT_REGISTRY = {
    "brain_mri_t1": {
        "filename": "brain_mri_t1.pt",
        "url": "https://github.com/invesalius/weights/raw/main/brain_mri_t1/brain_mri_t1.pt",
    },
    "trachea_ct": {
        "filename": "trachea_ct.pt",
        "url": "https://github.com/invesalius/weights/raw/main/trachea_ct/trachea_ct.pt",
    },
    "mandible_jit_ct": {
        "filename": "mandible_jit_ct.pt",
        "url": "https://github.com/invesalius/weights/raw/main/mandible_jit_ct/mandible_jit_ct.pt",
    },
    "cranioplasty_jit_ct_binary": {
        "filename": "cranioplasty_jit_ct_binary.pt",
        "url": "https://github.com/invesalius/weights/raw/main/cranioplasty_jit_ct_binary/cranioplasty_jit_ct_binary.pt",
    },
    # FastSurfer parcellation views (ONNX, reference segment.py:576-613)
    "fastsurfer_axial": {"filename": "fastsurfer_axial.onnx", "url": None},
    "fastsurfer_coronal": {"filename": "fastsurfer_coronal.onnx", "url": None},
    "fastsurfer_sagittal": {"filename": "fastsurfer_sagittal.onnx", "url": None},
}


def sha256sum(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_url_to_file(url: str, dst: Path, hash_sha256: Optional[str] = None,
                         progress: Optional[Callable[[float], None]] = None,
                         timeout: float = 15.0) -> Path:
    """Download with optional sha256 verify (reference net/utils.py).
    A connect/read timeout keeps zero-egress environments failing fast
    instead of hanging."""
    import urllib.request

    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(dst.suffix + ".part")
    with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        total = int(r.headers.get("Content-Length", 0) or 0)
        done = 0
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            if progress and total:
                progress(done / total)
    if hash_sha256 and sha256sum(tmp) != hash_sha256:
        tmp.unlink()
        raise ValueError(f"sha256 mismatch for {url}")
    tmp.replace(dst)
    return dst


def get_weight_file(model_name: str, hash_sha256: Optional[str] = None,
                    auto_download: bool = True) -> Path:
    """Resolve (and if needed fetch) a model's weight file under ai/
    (reference segment.py:401-440 layout)."""
    info = WEIGHT_REGISTRY[model_name]
    path = models_dir() / model_name / info["filename"]
    if path.exists():
        if hash_sha256 and sha256sum(path) != hash_sha256:
            raise ValueError(f"cached weights at {path} fail sha256 check")
        return path
    if not auto_download or info["url"] is None:
        raise FileNotFoundError(path)
    try:
        return download_url_to_file(info["url"], path, hash_sha256)
    except OSError as e:
        raise FileNotFoundError(
            f"weights for {model_name!r} not cached at {path} and download "
            f"failed ({e}); place the reference checkpoint there manually"
        ) from e

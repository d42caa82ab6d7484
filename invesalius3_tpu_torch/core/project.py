"""Project: the document model with .inv3 save/open and HDF5/NIfTI export
(port of invesalius3_tpu/core/project.py).

Reference: invesalius/project.py ``Project`` :60 (mask_dict / surface_dict
/ measurement_dict, image matrix + versions), SavePlistProject :219 (a tar,
gzip-compressed or not, of main.plist + matrix.dat + mask_*.dat/.plist +
surface_*.vtp/.plist + measurements.plist), OpenPlistProject :345,
export_to_hdf5/nifti :586/:620; format_version 1.1.

The volume, the masks and the image versions live on a device (the card
unless the caller passes "cpu"); every member is written from a host copy
(``.cpu().numpy()``), so the archive's bytes are the JAX package's for the
same arrays, save for ``date`` and ``invesalius_version`` in main.plist.
"""

from __future__ import annotations

import datetime
import io
import plistlib
import tarfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from invesalius3_tpu_torch import __version__, constants as const
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.surface import Surface
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


class Project:
    def __init__(self):
        self.name: str = ""
        self.modality: str = "CT"
        self.original_orientation: str = "AXIAL"
        self.window: float = 255.0
        self.level: float = 127.5
        self.threshold_range = (0, 0)
        self.volume: Optional[Volume] = None
        self.mask_dict: Dict[int, Mask] = {}
        self.surface_dict: Dict[int, Surface] = {}
        self.measurement_dict: Dict[int, dict] = {}
        self.image_fiducials = np.full((3, 3), np.nan)
        self.compress = False
        # [(label, (Z,Y,X) tensor)] filtered copies of the volume; entry 0,
        # "original", is the matrix itself and is not duplicated on disk
        self.image_versions: list = []

    # -- construction ------------------------------------------------------------
    @classmethod
    def from_matrix(cls, name: str, matrix, orientation: str = "AXIAL",
                    spacing=(1.0, 1.0, 1.0), modality: str = "CT",
                    window_width: Optional[float] = None,
                    window_level: Optional[float] = None,
                    device=DEFAULT_DEVICE) -> "Project":
        """New project from a numpy 3D array on ``device`` (reference
        control.py:1033 create_project_from_matrix; the default window
        spans the data range).  Integer arrays that fit int16 are cast."""
        matrix = np.asarray(matrix)
        if matrix.ndim != 3:
            raise ValueError("matrix must be a 3D array")
        if matrix.dtype != np.int16:
            if (matrix.dtype.kind not in "iu"
                    or matrix.min() < -32768 or matrix.max() > 32767):
                raise ValueError(
                    f"matrix must be int16-representable (got {matrix.dtype}"
                    f" range [{matrix.min()}, {matrix.max()}])")
        lo, hi = int(matrix.min()), int(matrix.max())
        proj = cls()
        proj.name = name
        proj.modality = modality
        proj.original_orientation = orientation
        proj.window = float(window_width if window_width is not None
                            else hi - lo)
        proj.level = float(window_level if window_level is not None
                           else (hi + lo) // 2)
        proj.volume = Volume.from_numpy(matrix.astype(np.int16),
                                        spacing=tuple(spacing), device=device)
        return proj

    def make_slice(self):
        """A Slice over this project's volume with the project's window."""
        from invesalius3_tpu_torch.core.slice import Slice

        slc = Slice(self.volume)
        slc.set_window(self.window, self.level)
        return slc

    @property
    def spacing(self):
        return self.volume.spacing if self.volume else (1.0, 1.0, 1.0)

    @property
    def affine(self):
        return self.volume.affine if self.volume else None

    def add_mask(self, mask: Mask) -> int:
        self.mask_dict[mask.index] = mask
        return mask.index

    def add_surface(self, surface: Surface) -> int:
        self.surface_dict[surface.index] = surface
        return surface.index

    # -- .inv3 save/open -----------------------------------------------------------
    def save(self, path, compress: Optional[bool] = None) -> None:
        from invesalius3_tpu_torch.io import mesh_io

        if compress is None:
            compress = self.compress
        matrix = _host(self.volume.data)
        project = {
            "format_version": const.INV3_FORMAT_VERSION,
            "invesalius_version": f"invesalius3_tpu_torch-{__version__}",
            "date": datetime.datetime.now().isoformat(),
            "compress": bool(compress),
            "name": self.name,
            "modality": self.modality,
            "orientation": self.original_orientation,
            "window_width": float(self.window),
            "window_level": float(self.level),
            "scalar_range": [int(matrix.min()), int(matrix.max())],
            "spacing": list(self.spacing),
            "image_fiducials": self.image_fiducials.tolist(),
            "matrix": {
                "filename": "matrix.dat",
                "shape": list(matrix.shape),
                "dtype": str(matrix.dtype),
            },
            "image_versions": [],
            "annotations": {},
            "measurements": "measurements.plist",
        }
        if self.affine is not None:
            project["affine"] = np.asarray(self.affine).tolist()

        members: Dict[str, bytes] = {"matrix.dat": matrix.tobytes()}

        for i, (label, mat) in enumerate(self.image_versions):
            if label == "original":
                continue  # the matrix itself; don't duplicate bytes
            arr = _host(mat)
            fname = f"image_version_{i}.dat"
            project["image_versions"].append({
                "label": label, "filename": fname,
                "shape": list(arr.shape), "dtype": str(arr.dtype)})
            members[fname] = arr.tobytes()

        masks = {}
        for index, mask in self.mask_dict.items():
            dat = f"mask_{mask.index}.dat"
            plist = f"mask_{mask.index}.plist"
            members[dat] = mask.to_bordered_matrix().tobytes()
            members[plist] = mask.save_plist(dat)
            masks[str(index)] = plist
        project["masks"] = masks

        surfaces = {}
        for index, surf in self.surface_dict.items():
            vtp = f"surface_{surf.index}.vtp"
            plist = f"surface_{surf.index}.plist"
            members[vtp] = mesh_io.vtp_text(surf.vertices, surf.faces).encode()
            members[plist] = surf.save_plist(vtp)
            surfaces[str(index)] = plist
        project["surfaces"] = surfaces

        # plist keys must be strings; measurement indices are ints in memory
        members["measurements.plist"] = plistlib.dumps(
            {str(k): v for k, v in self.measurement_dict.items()})
        members["main.plist"] = plistlib.dumps(project)

        mode = "w:gz" if compress else "w"
        with tarfile.open(path, mode) as tar:
            for name, data in members.items():
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    @classmethod
    def open(cls, path, device=DEFAULT_DEVICE) -> "Project":
        """A project read from an .inv3 archive, its volume, versions and
        masks on ``device`` (the card unless "cpu")."""
        from invesalius3_tpu_torch.io import mesh_io

        dev = resolve_device(device)
        proj = cls()
        with tarfile.open(path, "r:*") as tar:
            members = {Path(m.name).name: tar.extractfile(m).read()
                       for m in tar.getmembers() if m.isfile()}

        main = plistlib.loads(members["main.plist"])
        proj.name = main["name"]
        proj.modality = main["modality"]
        proj.original_orientation = main["orientation"]
        proj.window = main["window_width"]
        proj.level = main["window_level"]
        proj.threshold_range = tuple(main.get("scalar_range", (0, 0)))
        spacing = tuple(main["spacing"])
        proj.compress = main.get("compress", False)
        if "image_fiducials" in main:
            proj.image_fiducials = np.asarray(main["image_fiducials"])

        minfo = main["matrix"]
        shape = tuple(int(s) for s in minfo["shape"])
        matrix = np.frombuffer(members[minfo["filename"]],
                               np.dtype(minfo["dtype"])).reshape(shape)
        affine = np.asarray(main["affine"]) if "affine" in main else None
        proj.volume = Volume.from_numpy(
            matrix, spacing=spacing, affine=affine, modality=proj.modality,
            window_width=proj.window, window_level=proj.level, device=dev)

        proj.image_versions = [("original", proj.volume.data)]
        for vinfo in main.get("image_versions", []):
            arr = np.frombuffer(
                members[vinfo["filename"]], np.dtype(vinfo["dtype"])
            ).reshape(tuple(int(s) for s in vinfo["shape"]))
            proj.image_versions.append(
                (vinfo["label"], torch.from_numpy(arr.copy()).to(dev)))
        if len(proj.image_versions) == 1:
            proj.image_versions = []  # none beyond the original were stored

        for _, plist_name in main.get("masks", {}).items():
            info = plistlib.loads(members[plist_name])
            m = Mask.load_plist(members[plist_name], members[info["mask_file"]],
                                device=dev)
            m.spacing = spacing
            proj.mask_dict[m.index] = m

        for _, plist_name in main.get("surfaces", {}).items():
            info = plistlib.loads(members[plist_name])
            vtp_member = info.get("polydata") or info["surface_file"]
            verts, faces = mesh_io.read_vtp_bytes(members[Path(vtp_member).name])
            proj.surface_dict[info["index"]] = Surface.load_plist(
                members[plist_name], verts, faces)

        proj.measurement_dict = {
            (int(k) if str(k).lstrip("-").isdigit() else k): v
            for k, v in plistlib.loads(members["measurements.plist"]).items()}
        return proj

    # -- exports (reference project.py:586/:620) ----------------------------------
    def export_to_hdf5(self, path) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("image", data=_host(self.volume.data))
            f["image"].attrs["spacing"] = self.spacing
            if self.affine is not None:
                f.create_dataset("affine", data=np.asarray(self.affine))
            grp = f.create_group("masks")
            for idx, m in self.mask_dict.items():
                d = grp.create_dataset(str(idx), data=_host(m.data))
                d.attrs["name"] = m.name
                d.attrs["threshold_range"] = m.threshold_range

    def export_to_nifti(self, path, mask_index: Optional[int] = None) -> None:
        from invesalius3_tpu_torch.io.nifti import write_nifti

        if mask_index is None:
            data = _host(self.volume.data)
        else:
            data = _host(self.mask_dict[mask_index].visible_array()).astype(np.uint8) * 255
        write_nifti(path, data, affine=self.affine, spacing=self.spacing)

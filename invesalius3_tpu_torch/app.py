"""The headless application (port of invesalius3_tpu/app.py), on the card
unless asked for the CPU:

    python -m invesalius3_tpu_torch.app --import-file ct.nii -t Bone \\
        -e out.stl -s out.inv3 --algorithm ca_smoothing
    app.main([...], device="cpu")   # the same flow on the CPU

The batch flags of the reference's command line (reference app.py:391-518):
  -i/--import DIR      import a DICOM directory (its largest series)
  --import-all         with -i and -e: one surface a series, named
                       <stem>_<last 8 characters of the series UID><suffix>
  --import-folder DIR  import a bitmap stack directory (needs Pillow)
  --spacing SX,SY,SZ   the bitmap stack's spacing
  --import-file FILE   import a NIfTI/Analyze file, a PAR/REC pair or an
                       .inv3 project
  --import-surface F   import a mesh (STL/PLY/OBJ/VTP/3MF/VRML/.bin) as a
                       surface, small holes capped; alone: report and
                       re-export it with -e
  -t/--threshold A,B   threshold range or preset name (e.g. Bone)
  -e/--export FILE     surface of the mask, exported (STL/PLY/OBJ/...)
  -a/--export-to-all B one surface per threshold preset, B_<preset>.<ext>
  -s/--save FILE       save the .inv3 project
  --export-project F   export the project to HDF5 (.h5) or NIfTI (.nii)
  --quality            surface quality preset name
  --algorithm          surface algorithm: Default | ca_smoothing | Binary
  --debug              print every bus event

  --cranioplasty IN OUT  cranioplasty implant: the NIfTI IN through the
                       implant U-Net (binary method), its mask's surface
                       exported to OUT; needs the cranioplasty_jit_ct_binary
                       checkpoint under the models dir

--serve, --shell, --remote-host and --use-pedal need modules the port does
not have yet: each exits with a message naming the missing module.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from invesalius3_tpu_torch import constants as const, events
from invesalius3_tpu_torch.core.project import Project
from invesalius3_tpu_torch.core.session import Session
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.utils.i18n import tr

# flags whose module is still to port: (argparse dest, what they need)
_NOT_PORTED = {
    "serve": "--serve needs server.py",
    "shell": "--shell needs the port's ops namespace (app.run_shell)",
    "remote_host": "--remote-host needs net/remote_control.py",
    "use_pedal": "--use-pedal needs net/pedal_connection.py",
}


def parse_command_line(argv=None) -> argparse.Namespace:
    """The JAX package's flags, every one of them."""
    p = argparse.ArgumentParser(prog="invesalius3_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", "--import", dest="dicom_dir", help="import a DICOM directory")
    p.add_argument("--import-all", dest="import_all", action="store_true",
                   help="import all series (not only the largest)")
    p.add_argument("--import-folder", dest="bitmap_dir", help="import a bitmap stack directory")
    p.add_argument("--import-file", dest="other_file", help="import NIfTI/Analyze/.inv3 file")
    p.add_argument("-t", "--threshold", help="'min,max' or a preset name (e.g. Bone)")
    p.add_argument("-e", "--export", dest="export_surface", help="export surface mesh file")
    p.add_argument("--import-surface", dest="import_surface", metavar="FILE",
                   help="import a mesh file as a surface; small holes are capped")
    p.add_argument("-a", "--export-to-all", dest="export_all",
                   help="basename: export one surface per threshold preset")
    p.add_argument("-s", "--save", dest="save_project", help="save .inv3 project")
    p.add_argument("--export-project", help="export project to .h5 or .nii[.gz]")
    p.add_argument("--no-gui", action="store_true", default=True,
                   help="headless mode (always)")
    p.add_argument("--quality", default=const.DEFAULT_SURFACE_QUALITY,
                   choices=list(const.SURFACE_QUALITY))
    p.add_argument("--algorithm", default="Default",
                   choices=["Default", "ca_smoothing", "Binary"])
    p.add_argument("--spacing", help="override spacing 'sx,sy,sz' (bitmap import)")
    p.add_argument("--debug", action="store_true", help="log every bus event")
    p.add_argument("--remote-host", dest="remote_host",
                   help="mirror the event bus to host:port")
    p.add_argument("--use-pedal", dest="use_pedal", action="store_true",
                   help="enable MIDI pedal input")
    p.add_argument("--debug-efield", dest="debug_efield", action="store_true",
                   help="use the synthetic e-field solver (a session setting)")
    p.add_argument("--cranioplasty", nargs=2, metavar=("INPUT", "OUTPUT"),
                   help="run cranioplasty implant segmentation")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="start the HTTP viewer server on PORT and block")
    p.add_argument("--shell", action="store_true",
                   help="interactive Python shell after the batch steps")
    return p.parse_args(argv)


def _refuse_not_ported(args) -> None:
    for dest, need in _NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            raise SystemExit(f"invesalius3_tpu_torch: {need}, which is not "
                             "ported yet")


def _dicom_groups(directory):
    from invesalius3_tpu_torch.io import dicom

    groups = dicom.load_dicom_dir(directory)
    if not groups:
        raise SystemExit(tr("no DICOM series found in {dir}").format(dir=directory))
    return groups


def _dicom_volume(group, device) -> Volume:
    """A DICOM series' volume on ``device``: its tensor, not a copy."""
    from invesalius3_tpu_torch.io import dicom

    data, spacing, affine = dicom.group_to_volume(group, device=device)
    return Volume.from_tensor(data, spacing=spacing, affine=affine,
                              modality=group.files[0].get("Modality", "CT"))


def import_data(args, device) -> Volume:
    """The volume of -i (the largest series), --import-folder or
    --import-file (NIfTI/Analyze, PAR/REC or .inv3) on ``device``."""
    if args.dicom_dir:
        groups = _dicom_groups(args.dicom_dir)
        return _dicom_volume(max(groups, key=lambda g: len(g.files)), device)
    if args.bitmap_dir:
        from invesalius3_tpu_torch.io import bitmap

        spacing = (1.0, 1.0, 1.0)
        if args.spacing:
            spacing = tuple(float(x) for x in args.spacing.split(","))
        data, spacing = bitmap.load_bitmap_dir(args.bitmap_dir, spacing)
        return Volume.from_numpy(data, spacing=spacing, device=device)
    if not args.other_file:
        raise SystemExit(tr("no input given: use -i / --import-folder / --import-file"))
    path = Path(args.other_file)
    if path.suffix == ".inv3":
        return Project.open(path, device=device).volume
    if path.suffix.lower() in (".par", ".rec"):
        from invesalius3_tpu_torch.io import parrec

        data, spacing = parrec.read_par_rec(path)
        return Volume.from_numpy(data, spacing=spacing, device=device)
    from invesalius3_tpu_torch.io import nifti

    img = nifti.read_nifti(path)
    return Volume.from_numpy(img.data, spacing=img.spacing, affine=img.affine,
                             device=device)


def import_all(args, device) -> int:
    """--import-all: every DICOM series thresholded and, with -e, its surface
    exported as <stem>_<series UID[-8:]><suffix> (reference app.py:490-497)."""
    for g in _dicom_groups(args.dicom_dir):
        vol = _dicom_volume(g, device)
        gslc = Slice(vol)
        if args.threshold:
            tmin, tmax = parse_threshold(args.threshold, vol.modality)
            gslc.create_new_mask(threshold_range=(tmin, tmax))
        else:
            gslc.create_new_mask()
        if args.export_surface:
            surf = gslc.create_surface_from_mask(
                quality=args.quality, algorithm=args.algorithm)
            base = Path(args.export_surface)
            title = g.preview_info()["series_uid"][-8:]
            out = base.with_name(f"{base.stem}_{title}{base.suffix}")
            surf.export(str(out))
            print(tr("exported {path}").format(path=out), file=sys.stderr)
    return 0


def parse_threshold(spec: str, modality: str = "CT"):
    presets = const.THRESHOLD_PRESETS_CT if modality == "CT" else const.THRESHOLD_PRESETS_OTHER
    if spec in presets:
        return presets[spec]
    try:
        a, b = spec.split(",")
        return (float(a), float(b))
    except ValueError:
        raise SystemExit(f"bad threshold {spec!r}: use 'min,max' or one of {list(presets)}")


def _report(verb: str, path, surf) -> None:
    print(tr("{verb} {path}: {tris} triangles, volume={vol} mm^3, "
             "area={area} mm^2").format(
        verb=verb, path=path, tris=len(surf.faces), vol=f"{surf.volume:.1f}",
        area=f"{surf.area:.1f}"), file=sys.stderr)


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    """Run the batch flow of ``argv`` on ``device`` (the card unless "cpu");
    returns the exit status."""
    args = parse_command_line(argv)
    _refuse_not_ported(args)
    device = resolve_device(device)
    if args.debug:
        events.subscribe(
            events.wants_topic(lambda topic=None, **kw: print(f"[event] {topic} {kw}",
                                                              file=sys.stderr)),
            events.ALL_TOPICS,
        )

    session = Session()
    backup = session.recover_auto_backup()
    if backup is not None:  # the reference's CheckCrashRecovery (app.py:287-366)
        print(tr("previous session did not exit cleanly; auto-backup at "
                 "{path} (open with --import-file)").format(path=backup),
              file=sys.stderr)
    session.mark_running()
    if args.debug_efield:
        session.set_config("debug_efield", True)
    try:
        from invesalius3_tpu_torch.core.surface import import_surface_file

        if args.cranioplasty:
            return run_cranioplasty(*args.cranioplasty, device=device)
        if args.import_surface and not args.other_file:
            # standalone mesh flow: import (+hole-fill), report, re-export
            surf = import_surface_file(args.import_surface, device=device)
            _report(tr("imported"), args.import_surface, surf)
            if surf.filled_holes:
                print(tr("filled {n} holes").format(n=surf.filled_holes),
                      file=sys.stderr)
            if args.export_surface:
                surf.export(args.export_surface)
                print(tr("exported {path}").format(path=args.export_surface),
                      file=sys.stderr)
            return 0
        if args.import_all and args.dicom_dir:
            return import_all(args, device)
        volume = import_data(args, device)
        from invesalius3_tpu_torch.utils.logging import ensure_logging, get_logger

        ensure_logging(console=False)
        get_logger("app").info("imported volume %s %s spacing=%s",
                               volume.shape, volume.dtype, volume.spacing)
        print(tr("volume: {shape} {dtype} spacing={spacing}").format(
            shape=volume.shape, dtype=volume.dtype, spacing=volume.spacing),
            file=sys.stderr)

        slc = Slice(volume)
        project = Project()
        project.volume = volume
        project.modality = volume.modality
        project.name = "cli_project"

        if args.threshold:
            tmin, tmax = parse_threshold(args.threshold, volume.modality)
            mask = slc.create_new_mask(threshold_range=(tmin, tmax))
            project.add_mask(mask)
            n = int(mask.visible_array().sum())
            print(tr("threshold [{tmin}, {tmax}]: {n} voxels").format(
                tmin=tmin, tmax=tmax, n=n), file=sys.stderr)

        if args.import_surface:
            surf = import_surface_file(args.import_surface, device=device)
            project.add_surface(surf)
            _report(tr("imported"), args.import_surface, surf)

        if args.export_surface:
            if not slc.current_mask:
                slc.create_new_mask()
            surf = slc.create_surface_from_mask(
                quality=args.quality, algorithm=args.algorithm)
            project.add_surface(surf)
            surf.export(args.export_surface)
            _report(tr("exported"), args.export_surface, surf)

        if args.export_all:
            base = Path(args.export_all)
            presets = (const.THRESHOLD_PRESETS_CT if volume.modality == "CT"
                       else const.THRESHOLD_PRESETS_OTHER)
            for pname, (tmin, tmax) in presets.items():
                if pname == "Custom":
                    continue
                m = slc.create_new_mask(name=pname, threshold_range=(tmin, tmax))
                if not bool(m.visible_array().any()):
                    continue
                surf = slc.create_surface_from_mask(m, quality=args.quality,
                                                    algorithm=args.algorithm)
                out = base.with_name(f"{base.stem}_{pname.replace(' ', '_')}{base.suffix}")
                surf.export(str(out))
                print(f"exported {out}", file=sys.stderr)

        for m in slc.masks.values():
            project.add_mask(m)
        if getattr(slc, "_image_versions", None):
            project.image_versions = slc.image_versions

        if args.save_project:
            project.save(args.save_project)
            session.add_recent_project(args.save_project, project.name)
            print(tr("saved {path}").format(path=args.save_project), file=sys.stderr)

        if args.export_project:
            out = args.export_project
            if out.endswith((".h5", ".hdf5")):
                project.export_to_hdf5(out)
            else:
                project.export_to_nifti(out)
            print(tr("exported project to {path}").format(path=out), file=sys.stderr)
        return 0
    finally:
        session.exit()


def run_cranioplasty(input_path, output_path, device=DEFAULT_DEVICE) -> int:
    """Headless cranioplasty implant flow (reference segment.py:30
    run_cranioplasty_implant + app.py --cranioplasty) on ``device``."""
    import torch

    from invesalius3_tpu_torch.core.mask import Mask
    from invesalius3_tpu_torch.core.surface import create_surface_from_mask
    from invesalius3_tpu_torch.io.nifti import read_nifti
    from invesalius3_tpu_torch.models.segment import ImplantSegmenter

    device = resolve_device(device)
    img = read_nifti(input_path)
    seg = ImplantSegmenter(method="binary", device=device)
    prob, mask_arr = seg.segment(img.data)
    m = Mask()
    m.data = torch.from_numpy(mask_arr).to(device)
    surf = create_surface_from_mask(m, img.spacing, name="implant")
    surf.export(output_path)
    print(tr("implant exported to {path}: {tris} triangles").format(
        path=output_path, tris=len(surf.faces)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

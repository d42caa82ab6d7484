"""Interactive console with the application's objects bound (port of
invesalius3_tpu/console.py; reference invesalius/gui/interactive_shell.py,
an embedded Python shell preloaded with the app's objects).

    python -m invesalius3_tpu_torch.console [volume-file]

runs a stdlib ``code.interact`` with the port's domain objects and, given a
NIfTI file, its volume on the card (``make_context(path, device="cpu")``
for the CPU).
"""

from __future__ import annotations

import code
import sys

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def make_context(volume_path: str | None = None, device=DEFAULT_DEVICE) -> dict:
    """The console's namespace; ``device`` (the card unless "cpu") is
    where the volume goes, and the card is required unless "cpu"."""
    import numpy as np
    import torch

    import invesalius3_tpu_torch as inv
    from invesalius3_tpu_torch import constants as const, events
    from invesalius3_tpu_torch.core.project import Project
    from invesalius3_tpu_torch.core.session import Session
    from invesalius3_tpu_torch.core.slice import Slice
    from invesalius3_tpu_torch.core.volume import Volume
    from invesalius3_tpu_torch.ops import (
        floodfill, marching, mesh, morphology, projections, raycast,
        threshold, watershed,
    )

    dev = resolve_device(device)
    ctx = {
        "np": np, "torch": torch, "inv": inv, "const": const, "events": events,
        "Volume": Volume, "Slice": Slice, "Project": Project,
        "Session": Session, "device": dev, "ops": {
            "threshold": threshold, "floodfill": floodfill,
            "watershed": watershed, "marching": marching, "mesh": mesh,
            "morphology": morphology, "projections": projections,
            "raycast": raycast,
        },
    }
    if volume_path:
        from invesalius3_tpu_torch.io.nifti import read_nifti

        img = read_nifti(volume_path)
        vol = Volume.from_numpy(img.data, spacing=img.spacing, affine=img.affine,
                                device=dev)
        ctx["volume"] = vol
        ctx["slc"] = Slice(vol)
    return ctx


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ctx = make_context(argv[0] if argv else None, device=device)
    banner = (
        "invesalius3_tpu_torch interactive console\n"
        f"bound: {', '.join(sorted(ctx))}\n"
    )
    code.interact(banner=banner, local=ctx)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

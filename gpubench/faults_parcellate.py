"""Faults planted in the parcellation's 2.5D pipeline, for showing that its
check catches them (``gpubench/tests`` on the CPU; on the card, the
program's readings taken inside ``planted``).  Each wraps one part of
``models/fastsurfer.py`` for the block."""

from __future__ import annotations

from gpubench.faults import _patched


def _coronal_batch_left_out(middle: bool):
    """The coronal view's first batch of slices, or the one holding its
    middle slice, left out of the sum: its logits zero where they are
    weighted and added."""
    def fault(orig):
        def view_logits(self, batch, view):
            logits = orig(self, batch, view)
            if view != "coronal":
                return logits
            calls = self.__dict__.get("coronal_calls", 0)
            self.coronal_calls = calls + 1
            at = (batch.shape[-2] // 2) // self.batch_size if middle else 0
            return logits.new_zeros(logits.shape) if calls == at else logits
        return view_logits
    return fault


batch_left_out = _coronal_batch_left_out(False)
middle_batch_left_out = _coronal_batch_left_out(True)


def sagittal_unmapped(orig):
    """The sagittal logits added to the first of the full classes, each
    sagittal index taken as the full index."""
    import torch.nn.functional as F

    from invesalius3_tpu_torch.models import fastsurfer

    return lambda logits, **kw: F.pad(logits, (0, fastsurfer.NUM_CLASSES - logits.shape[-1]))


def equal_weights(orig):
    """Each view weighted 1/3."""
    return {view: 1.0 / 3.0 for view in orig}


def planted(fault: str):
    """The context that plants ``fault`` (a name of this module)."""
    from invesalius3_tpu_torch.models import fastsurfer

    where = {"batch_left_out": (fastsurfer.FastSurferPipeline, "view_logits"),
             "middle_batch_left_out": (fastsurfer.FastSurferPipeline, "view_logits"),
             "sagittal_unmapped": (fastsurfer, "apply_sagittal_mapping"),
             "equal_weights": (fastsurfer.FastSurferPipeline, "VIEW_WEIGHTS")}
    owner, name = where[fault]
    return _patched(owner, name, globals()[fault])

"""Faults planted in the program, for showing that the check catches them
(``gpubench/tests`` on the CPU, ``python -m gpubench.control --fault`` on
the card).  Each wraps one function of the program for the block."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def altered_labels(orig):
    """The watershed's answer altered where it is produced: one voxel relabelled."""
    def run(*a, **k):
        labels = orig(*a, **k)
        labels.view(-1)[labels.numel() // 3] += 1
        return labels
    return run


def altered_probability(orig):
    """The segmentation's answer altered where it is produced: one voxel's
    probability moved by 0.2."""
    def run(self, *a, **k):
        prob, mask = orig(self, *a, **k)
        prob.reshape(-1)[prob.size // 2] += 0.2
        return prob, mask
    return run


def half_batch(orig):
    """A training step on the first half of its batch, the mean taken over it."""
    def run(model, opt, x, y, *a, **k):
        n = x.shape[0] // 2
        return orig(model, opt, x[:n], y[:n], *a, **k)
    return run


def unchanged(orig):
    """A training step that leaves the parameters as they were."""
    def step(self):
        self.count += 1
    return step


def planted(fault: str):
    """The context that plants ``fault`` (a name of this module) in the
    program."""
    from invesalius3_tpu_torch.models import segment, train
    from invesalius3_tpu_torch.ops import watershed

    where = {"altered_labels": (watershed, "watershed"),
             "altered_probability": (segment.BrainSegmenter, "segment"),
             "half_batch": (train, "train_step"),
             "unchanged": (train.Adam, "step")}
    owner, name = where[fault]
    return _patched(owner, name, globals()[fault])

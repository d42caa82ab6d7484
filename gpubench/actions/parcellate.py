"""A whole-brain parcellation as a radiologist or a neuroscience lab runs
it in InVesalius: the app's ``fastsurfer_subpart`` job,
``models/segment.SubpartSegmenter(variables=...).segment(t1, batch_size=8)``,
up to the FreeSurfer-id labels and the mask on the host.

The T1 volume is ``brain_segment``'s phantom, made on the card from the
seed and handed to the job on the host, as the app hands it; the three
views' weights are drawn from the seed (``gen_fastsurfer``) and handed over
as host tensors, as a checkpoint loader leaves them.  Every action
parcellates the same volume.

Judged against ``reference/fastsurfer.parcellate`` (float32, TF32 off), run
once after the window on the same volume and weights, by four numbers of
each kept action's labels:

- ``id_mask_faults`` (a guarantee, limit 0): voxels whose id is not in the
  configuration's table, or whose mask is not 255 exactly where the label
  is above 0 (every voxel, if a shape or dtype is wrong);
- ``label_gap``: over the voxels whose label differs from the reference's,
  the reference's own margin between its label and the program's, over
  the standard deviation of the reference's logits, at the
  ``GAP_QUANTILE`` quantile.  Not the largest: a random 64-filter network
  is chaotic where a 2x2 window's values nearly tie, since a pooling index
  that flips on a rounding moves the unpooled values to another pixel;
- ``decided_flip_share``: the share of the voxels whose reference top two
  logits differ by more than ``DECIDED`` standard deviations whose label
  differs;
- ``batch_flip_share``: the same share in each view's batch of slices
  (``batch`` slices along each axis), the largest.  A batch of one view
  left out of the sum, or added twice, moves its slices alone: their share
  stands above the chaos that the whole volume's share averages.
The spread takes out the scale each seed's weights give the logits.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import counts_fastsurfer, gen, gen_fastsurfer
from gpubench.actions import base
from gpubench.reference import fastsurfer as ref

# set from the readings in PERF.md (the program's seeds, the control's, the
# faults'; 256^3, 5x5 convolutions, on the card), each near the geometric
# mean of the sound runs' largest reading and the smallest of the fp8
# control or of the fault it is for: label_gap 0.803 and 1.821, the flip
# share 0.064 and 0.328, a batch's flip share 0.109 and 0.545 (the
# coronal view's first batch left out; fp8 from 0.364)
GAP_QUANTILE = 0.99
DECIDED = 0.1
LIMITS = {"id_mask_faults": 0, "label_gap": 1.3, "decided_flip_share": 0.15,
          "batch_flip_share": 0.24}


def batch_shares(flips: torch.Tensor, decided: torch.Tensor, batch: int) -> torch.Tensor:
    """The share of ``decided`` voxels that ``flips`` in each block of
    ``batch`` slices along each axis of the (D, H, W) volume (a block with
    no decided voxel reads 0)."""
    out = []
    for axis in range(3):
        others = tuple(a for a in range(3) if a != axis)
        f = (flips & decided).sum(others)
        d = decided.sum(others)
        n = -(-len(f) // batch) * batch
        f, d = (torch.nn.functional.pad(t, (0, n - len(t))).view(-1, batch).sum(1)
                for t in (f, d))
        out.append(f / d.clamp(min=1))
    return torch.cat(out)


def readings(labels: np.ndarray, mask: np.ndarray, want: dict) -> dict:
    """The four numbers of one answer against the reference's ``logits``
    (on its device), its ``top2``, its ``scale`` and the ``batch`` of
    slices its views took."""
    logits, top2, ids = want["logits"], want["top2"], want["ids"]
    dev = logits.device
    if labels.shape != tuple(logits.shape[:-1]) or labels.dtype != np.int32 \
            or mask.shape != labels.shape or mask.dtype != np.uint8:
        return {"id_mask_faults": int(np.prod(logits.shape[:-1])),
                "label_gap": float("inf"), "decided_flip_share": 1.0,
                "batch_flip_share": 1.0}
    lab = torch.from_numpy(labels).to(dev).long()
    index = torch.full((int(ids.max()) + 2,), -1, dtype=torch.int64, device=dev)
    index[ids.long()] = torch.arange(len(ids), device=dev)
    got = index[lab.clamp(-1, len(index) - 1)]  # -1: not an id of the table
    foreign = got < 0
    faults = int(foreign.sum()) + int((torch.from_numpy(mask).to(dev).long()
                                       != torch.where(lab > 0, 255, 0)).sum())
    got = torch.where(foreign, top2.indices[..., 1], got)  # counted in faults already
    differ = got != top2.indices[..., 0]
    n = int(differ.sum())
    gap = 0.0
    if n:
        margin = (top2.values[..., 0] - logits.gather(-1, got[..., None])[..., 0])[differ]
        gap = float(margin.sort().values[min(n - 1, int(GAP_QUANTILE * n))]) / want["scale"]
    decided = want["decided"]
    flips = float((differ & decided).sum()) / max(1, int(decided.sum()))
    worst = float(batch_shares(differ, decided, want["batch"]).max())
    return {"id_mask_faults": faults, "label_gap": gap, "decided_flip_share": flips,
            "batch_flip_share": worst}


class Action(base.Action):
    def make_inputs(self) -> None:
        vol = dict(self.traffic["volume"])
        t1 = getattr(gen, vol.pop("kind"))(vol, self.seed, self.device)
        self.state = gen_fastsurfer.state(self.cfg, self.seed, t1)
        self.image = t1.cpu().numpy()
        self.flops_per_action = counts_fastsurfer.parcellate_flops(self.cfg)

    def setup(self) -> None:
        self.make_inputs()
        from invesalius3_tpu_torch.models import segment

        self.segmenter = segment.SubpartSegmenter(
            variables=self.state, filters=int(self.cfg["filters"]),
            conform_size=int(self.cfg["conform"]), device=self.device)
        self.warm()

    def run(self) -> dict:
        labels, mask = self.segmenter.segment(self.image, batch_size=self.traffic["batch"])
        return {"labels": labels, "mask": mask}

    def program_state_free(self) -> None:
        self.segmenter = None

    def parcellation(self, quant=None):
        """The reference's (logit sum, labels) on the device."""
        states = {v: {k: t.to(self.device) for k, t in s.items()} for v, s in self.state.items()}
        return ref.parcellate(torch.from_numpy(self.image).to(self.device), states, self.cfg,
                              self.traffic["batch"], quant)

    def reference(self) -> dict:
        """The reference's logit sum (on the device), its top two, the
        voxels they decide, the logits' spread and the batch of slices."""
        logits, _ = self.parcellation()
        top2 = logits.topk(2, dim=-1)
        scale = float(logits.std()) or 1.0
        return {"logits": logits, "top2": top2, "scale": scale,
                "decided": top2.values[..., 0] - top2.values[..., 1] > DECIDED * scale,
                "ids": torch.tensor(self.cfg["class_ids"], dtype=torch.int32,
                                    device=self.device),
                "batch": int(self.traffic["batch"])}

    def control(self) -> dict:
        labels = self.parcellation("fp8")[1]
        return {"labels": labels.cpu().numpy(),
                "mask": ((labels > 0).to(torch.uint8) * 255).cpu().numpy()}

    def judge(self, answers, want) -> list:
        worst = dict.fromkeys(LIMITS, 0.0)
        for out in answers:
            r = readings(out["labels"], out["mask"], want)
            self.failed += int(any(r[k] > LIMITS[k] for k in LIMITS))
            worst = {k: max(worst[k], r[k]) for k in LIMITS}
        return [base.check(k, worst[k], LIMITS[k]) for k in LIMITS]

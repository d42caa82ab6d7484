"""The deep-learning segmentation a radiologist runs on an MRI:
``models/segment.BrainSegmenter(variables=...).segment(t1)``, up to the
probability and the mask on the host.

The T1 volume and the U-Net's weights are made on the card from the seed;
every action segments the same volume.  Judged against
``reference/unet3d.segment`` (float32, TF32 off), run once after the window
on the same volume and weights, by one number: the widest gap between the
kept action's logits (its probabilities' log-odds) and the reference's,
over the spread (standard deviation) of the reference's logits, where a
voxel whose mask differs from the reference's counts at least the
reference's own distance from the threshold.  The spread takes out the
scale that each seed's weights give the logits, which scales every
rounding gap with it.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import counts, gen
from gpubench.actions import base
from gpubench.reference import unet3d as ref

# set from the readings in PERF.md (the program's dozen seeds, the control's three)
LOGIT_GAP_LIMIT = 0.9
P_CLIP = 1e-7  # log-odds of float32 probabilities, kept finite at 0 and 1


def logits(prob: np.ndarray) -> np.ndarray:
    p = np.clip(prob.astype(np.float64), P_CLIP, 1 - P_CLIP)
    return np.log(p / (1 - p))


class Action(base.Action):
    def setup(self) -> None:
        self.make_inputs()
        from invesalius3_tpu_torch.models import segment, unet3d

        model = unet3d.Unet3D(init_features=int(self.cfg["init_features"]),
                              dtype=getattr(torch, self.cfg["conv_dtype"]))
        self.segmenter = segment.BrainSegmenter(variables=self.state, model=model,
                                                patch_size=self.traffic["patch"],
                                                overlap=self.traffic["overlap"],
                                                device=self.device)
        self.warm()

    def make_inputs(self) -> None:
        vol = dict(self.traffic["volume"])
        self.image = getattr(gen, vol.pop("kind"))(vol, self.seed, self.device)
        self.state = gen.unet3d_state(self.cfg, self.seed, self.device)
        n = len(ref.grid_starts(int(vol["n"]), self.traffic["patch"], self.traffic["overlap"])) ** 3
        self.flops_per_action = counts.unet3d_flops(self.traffic["patch"],
                                                    int(self.cfg["init_features"])) * n

    def run(self) -> dict:
        prob, mask = self.segmenter.segment(self.image, self.traffic["threshold"],
                                            self.traffic["batch"])
        return {"prob": prob, "mask": mask}

    def program_state_free(self) -> None:
        self.segmenter = None

    def reference(self, quant=None) -> dict:
        prob, mask = ref.segment(self.image, self.state, self.traffic["patch"],
                                 self.traffic["overlap"], self.traffic["batch"],
                                 self.traffic["threshold"], quant)
        return {"prob": prob.cpu().numpy(), "mask": mask.cpu().numpy()}

    def control(self) -> dict:
        return self.reference("fp8")

    def judge(self, answers, want) -> list:
        ref_logit = logits(want["prob"])
        scale = float(ref_logit.std()) or 1.0
        threshold = np.log(self.traffic["threshold"] / (1 - self.traffic["threshold"]))
        worst = 0.0
        for out in answers:
            gap = float(np.max(np.abs(logits(out["prob"]) - ref_logit)))
            flips = out["mask"] != want["mask"]
            if flips.any():
                gap = max(gap, float(np.max(np.abs(ref_logit[flips] - threshold))))
            self.failed += int(gap / scale > LOGIT_GAP_LIMIT)
            worst = max(worst, gap / scale)
        return [base.check("logit_gap", worst, LOGIT_GAP_LIMIT)]

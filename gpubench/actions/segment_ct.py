"""The deep-learning mandible segmentation a maxillofacial surgeon or a
3D-printing lab runs on a head CT:
``models/segment.MandibleSegmenter(variables=...).segment(ct, 0.5, 8)``,
the U-Net over 96^3 patches, up to the probability and the mask on the
host.

The CT is planes 0 to ``planes`` - 1 of the volume configuration's head CT,
made on the card from the seed; the U-Net's weights are the model
configuration's, drawn from the seed.  Judged as ``segment``'s action is,
by ``logit_gap`` against ``reference/unet3d.segment`` at the traffic's
patch size.
"""

from __future__ import annotations

import math

from gpubench import counts, gen, run
from gpubench.actions import segment
from gpubench.reference import unet3d as ref


class Action(segment.Action):
    def setup(self) -> None:
        self.make_inputs()
        import torch

        from invesalius3_tpu_torch.models import segment as program, unet3d

        model = unet3d.Unet3D(init_features=int(self.cfg["init_features"]),
                              dtype=getattr(torch, self.cfg["conv_dtype"]))
        self.segmenter = program.MandibleSegmenter(variables=self.state, model=model,
                                                   patch_size=self.traffic["patch"],
                                                   overlap=self.traffic["overlap"],
                                                   device=self.device)
        self.warm()

    def make_inputs(self) -> None:
        t = self.traffic
        ct = gen.head_ct(run.load_json(run.HERE / "configs" / f"{t['volume_config']}.json"),
                         self.seed, self.device)
        self.image = ct[: int(t["planes"])].contiguous()
        del ct
        self.state = gen.unet3d_state(self.cfg, self.seed, self.device)
        n = math.prod(len(ref.grid_starts(s, t["patch"], t["overlap"])) for s in self.image.shape)
        self.flops_per_action = counts.unet3d_flops(t["patch"], int(self.cfg["init_features"])) * n

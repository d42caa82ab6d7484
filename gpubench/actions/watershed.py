"""The user's "segment" click: ``ops/watershed.watershed`` on a CT and its
markers, as the slice viewer holds them on the card, run to labels ready.

The CTs are alike but for their noise, which sets how many refine rounds
a watershed takes.  The seed draws ``traffic["volumes"]`` of them from
the mix's ``catalogue`` of noise streams, whose CTs take the same rounds
at every level (``python -m gpubench.catalogue`` reads them), and the
order in which the actions take them: every seed does the same work on
CTs of its own.  Judged: the labels of the kept actions, voxel for voxel,
against ``reference/watershed.py`` run after the window on each kept
action's CT and the markers.  The control stops the finest level's
refine after two rounds, short of its fixpoint.
"""

from __future__ import annotations

from gpubench import gen
from gpubench.actions import base
from gpubench.reference import watershed as ref

CONTROL_FINEST_ROUNDS = 2


class Action(base.Action):
    def setup(self) -> None:
        self.make_inputs()
        from invesalius3_tpu_torch.ops import watershed

        self.program = watershed
        self.warm()

    def make_inputs(self) -> None:
        self.cts = [gen.head_ct(self.cfg, s, self.device)
                    for s in gen.pick(self.seed, self.traffic["catalogue"],
                                      int(self.traffic["volumes"]))]
        self.markers = gen.markers(self.cfg, self.device)
        self.volume = gen.cycle_item(self.seed, len(self.cts), 0)

    def run(self, volume=None) -> dict:
        v = self.volume if volume is None else volume
        rounds: list = []
        labels = self.program.watershed(self.cts[v], self.markers, self.traffic["algorithm"],
                                        multigrid_levels=self.cfg["multigrid_levels"],
                                        rounds=rounds)
        self.sync()
        return {"labels": labels, "rounds": rounds, "volume": v}

    def __call__(self, i: int) -> dict:
        out = self.run(gen.cycle_item(self.seed, len(self.cts), i))
        self.keep(i, out)
        return self.record(out)

    def record(self, out: dict) -> dict:
        return {"rounds": out["rounds"]}

    def check(self) -> list:
        volumes = sorted({out["volume"] for out in self.kept.values()})
        return self.judge(self.kept.values(), {v: self.reference(v) for v in volumes})

    def reference(self, volume=None, finest_rounds=None) -> dict:
        v = self.volume if volume is None else volume
        labels, _ = ref.watershed(self.cts[v], self.markers, self.cfg["multigrid_levels"],
                                  finest_rounds)
        return {"labels": labels, "volume": v}

    def control(self) -> dict:
        return self.reference(finest_rounds=CONTROL_FINEST_ROUNDS)

    def judge(self, answers, want) -> list:
        """``want``: the reference's answer, or one for each CT by number.
        The labels decide; the rounds a level ran are the per-layer
        ``ws_rounds``, not part of the answer."""
        worst = 0
        for out in answers:
            w = want.get(out["volume"], want) if "labels" not in want else want
            bad = int((out["labels"].long() != w["labels"].long()).sum())
            self.failed += int(bad > 0)
            worst = max(worst, bad)
        return [base.check("labels_differing", worst, 0)]

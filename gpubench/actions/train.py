"""A lab fine-tuning the segmentation model: ``models/train.train_step``
(train-mode batch norms, BCE, the backward and Adam) on a global batch of
p^3 patches cut anew each step, at origins drawn on the card from the
seed, out of a CT rescaled to [0, 1] through the trachea window, with the
Bone threshold of the same patches as targets.

Set-up builds the one model and optimizer the window trains, and drives
them through the first three steps (the warm-up) on batches it keeps.
Judged against ``reference/unet3d.train`` (float32, TF32 off) on the same
weights and batches: each leaf's first gradient norm (read from Adam's
first moment after step one) and each leaf's change norm after step three,
each gap over the larger of the reference leaf's norm and the median
leaf's: the gradients by the median leaf, the changes by the worst.  One step of the window, drawn from the seed, is
judged the same way: before it the parameters, Adam's moments and count
and its batch are copied on the card, after it the parameters and the
first moment; the reference takes one step from that copy, and the
program's gradient is read back from the moments (``mu' = B1 mu + (1 -
B1) g``).  That step starts from the program's own state, so the set-up
steps check the start from the seed's weights by themselves.  Leaves
whose reference gradient is under a thousandth of the median leaf's (the
conv biases that feed a train-mode norm, whose gradient is rounding) are
left out.
"""

from __future__ import annotations

import statistics
import time

import torch

from gpubench import counts, gen, run
from gpubench.actions import base
from gpubench.reference import unet3d as ref

CHECK_STEPS = 3
B1 = 0.9  # Adam's first-moment decay: after one step its moment is (1 - B1) g
DEAD_LEAF = 1e-3
# set from the readings in PERF.md (the program's dozen seeds, the control's
# three, the faults').  The losses are not compared, nor a gradient gap by
# the worst leaf: neither the control nor a fault reads them far enough
# above the program (PERF.md).
LIMITS = {"grad_norm_gap_median": 0.0085, "change_norm_gap": 0.3}
WINDOW_LIMITS = {"window_grad_gap_median": 0.06, "window_change_gap": 0.2}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def norm_gaps(got: dict, want: dict) -> tuple:
    """Each live leaf's gap of gradient norms and of change norms, over the
    larger of the reference leaf's and the median leaf's norm: the median
    leaf's gradient gap and the worst leaf's change gap."""
    g_ref, c_ref = want["grad_norms"], want["change_norms"]
    med_g = statistics.median(g_ref.values())
    live = [k for k, v in g_ref.items() if v >= DEAD_LEAF * med_g]
    med_c = statistics.median(c_ref[k] for k in live)
    return (statistics.median(abs(got["grad_norms"][k] - g_ref[k]) / max(g_ref[k], med_g)
                              for k in live),
            max(abs(got["change_norms"][k] - c_ref[k]) / max(c_ref[k], med_c) for k in live))


class Action(base.Action):
    window_step = None  # the kept window step: its batch and the state around it

    def setup(self) -> None:
        self.make_inputs()
        from invesalius3_tpu_torch.models import train, unet3d

        self.program = train
        model = unet3d.Unet3D(init_features=int(self.cfg["init_features"]),
                              dtype=getattr(torch, self.cfg["conv_dtype"])).to(self.device)
        model.load_state_dict(self.state, strict=True)
        self.model, self.opt = model, train.adam(model.parameters())
        self.names = [k for k, _ in model.named_parameters()]
        self.losses = []
        t = time.perf_counter()
        for step, (x, y) in enumerate(self.batches):
            self.losses.append(float(train.train_step(self.model, self.opt, x, y)))
            if step == 0:
                self.grad_norms = {k: n / (1 - B1)
                                   for k, n in leaf_norms(dict(zip(self.names, self.opt.mu)))
                                   .items()}
        self.change_norms = {k: float(torch.linalg.vector_norm((p.detach() - self.state[k])
                                                               .double()))
                             for k, p in model.named_parameters()}
        self.sync()
        self.warm_s = time.perf_counter() - t

    def make_inputs(self) -> None:
        t = self.traffic
        vol = run.load_json(run.HERE / "configs" / f"{t['volume_config']}.json")
        ct = gen.head_ct(vol, self.seed, self.device)
        lo, hi = vol["bone"]
        self.target = ((ct >= lo) & (ct <= hi)).to(torch.float32)
        self.image = gen.rescale01(gen.window_255(ct, *t["window"]))
        del ct
        self.state = gen.unet3d_state(self.cfg, self.seed, self.device)
        self.origins = gen.generator(self.seed, self.device, 4)
        self.batches = [self.feed() for _ in range(CHECK_STEPS)]
        self.flops_per_action = counts.train_step_flops(t["patch"], t["batch"],
                                                        int(self.cfg["init_features"]))

    def feed(self):
        p = self.traffic["patch"]
        o = gen.patch_origins(self.origins, tuple(self.image.shape), p, self.traffic["batch"])
        return gen.gather(self.image, o, p), gen.gather(self.target, o, p)

    def snapshot(self, moments: bool = True) -> dict:
        """Copies on the card of the parameters and Adam's first moment (and
        its second moment and count), by the parameters' names."""
        copy = lambda ts: {k: t.detach().clone() for k, t in zip(self.names, ts)}  # noqa: E731
        snap = {"params": copy(self.opt.params), "mu": copy(self.opt.mu)}
        if moments:
            snap.update(nu=copy(self.opt.nu), count=self.opt.count)
        return snap

    def run(self) -> dict:
        x, y = self.feed()
        self.program.train_step(self.model, self.opt, x, y)
        self.sync()
        return {}

    def __call__(self, i: int) -> dict:
        if i not in self.keep_at:
            return self.run()
        x, y = self.feed()
        before = self.snapshot()
        self.program.train_step(self.model, self.opt, x, y)
        self.window_step = {"step": i, "x": x, "y": y, "before": before,
                            "after": self.snapshot(moments=False)}
        self.sync()
        return {}

    def window_answer(self) -> dict:
        """The kept window step's gradient (read back from the first moment)
        and change norms, by leaf."""
        ws = self.window_step
        b, a = ws["before"], ws["after"]
        return {"grad_norms": leaf_norms({k: (a["mu"][k] - B1 * b["mu"][k]) / (1 - B1)
                                          for k in self.names}),
                "change_norms": leaf_norms({k: a["params"][k] - b["params"][k]
                                            for k in self.names})}

    def answer(self) -> dict:
        out = {"losses": self.losses, "grad_norms": self.grad_norms,
               "change_norms": self.change_norms}
        if self.window_step is not None:
            out["window"] = self.window_answer()
        return out

    def drive_to_kept_step(self) -> None:
        """Set-up, then the window's steps up to and with the kept one."""
        self.setup()
        i = 0
        while self.window_step is None:
            self(i)
            i += 1

    def first_answer(self) -> dict:
        self.drive_to_kept_step()
        return self.answer()

    def check(self) -> list:
        return self.judge([self.answer()], self.reference())

    def program_state_free(self) -> None:
        self.model = self.opt = self.image = self.target = None

    def reference(self, quant=None) -> dict:
        out = ref.train(self.state, self.batches, quant)
        ws = self.window_step
        if ws is not None:
            b = ws["before"]
            out["window"] = ref.train(b["params"], [(ws["x"], ws["y"])], quant, b["mu"], b["nu"],
                                      b["count"])
        return out

    def control(self) -> dict:
        """The reference in fp8 from the seed's weights, and from the
        program's state at the kept window step (the program is driven
        there first)."""
        if self.window_step is None:
            self.drive_to_kept_step()
            self.release()
        return self.reference("fp8")

    def judge(self, answers, want) -> list:
        limits = {**LIMITS, **WINDOW_LIMITS}
        worst = dict.fromkeys(limits, 0.0)
        for out in answers:
            gaps = dict(zip(LIMITS, norm_gaps(out, want)))
            # a kept step that never ran is an answer that never came
            gaps.update(zip(WINDOW_LIMITS, norm_gaps(out["window"], want["window"])
                            if "window" in out else (float("inf"),) * 2))
            self.failed += int(any(gaps[k] > limits[k] for k in limits))
            worst = {k: max(worst[k], gaps[k]) for k in limits}
        return [base.check(k, worst[k], limits[k]) for k in limits]

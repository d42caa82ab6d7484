"""What every action has: its inputs, one warm action, the answers of the
kept actions (drawn from the seed, and the last one), and the judgement
of those answers against the plain reference.

An action module defines ``Action`` with ``make_inputs`` (the inputs
alone, all the reference and the control need), ``setup`` (the inputs,
the program's objects, the warm action), ``run`` (one action, ended by a
synchronise; returns its answer), ``reference`` (the plain reference's
answer, worked out from the inputs alone), ``control`` (the reference in
the step of precision below the configuration's, or with one guarantee
broken) and ``judge`` (the numbers compared, each with its limit).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from gpubench import gen


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit}


class Action:
    flops_per_action = None  # operations one action needs, where counted
    warm_s = 0.0  # the warm-up's seconds within set-up

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 traced: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.traced = device, traced
        self.keep_at = set(gen.keep_indices(seed, int(traffic["keep"]),
                                            int(traffic["keep_horizon"])))
        self.kept: Dict[int, dict] = {}
        self.last = None
        self.failed = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """One action, not timed and not kept: every shape the window uses
        is built and every kernel loaded."""
        import time

        t = time.perf_counter()
        self.run()
        self.sync()
        self.warm_s = time.perf_counter() - t

    def keep(self, i: int, out: dict) -> None:
        if i in self.keep_at:
            self.kept[i] = out
        self.last = (i, out)

    def __call__(self, i: int) -> dict:
        out = self.run()
        self.keep(i, out)
        return self.record(out)

    def record(self, out: dict) -> dict:
        """What the per-layer metrics read of one action."""
        return {}

    def release(self) -> None:
        """Drop the program's objects once the window has closed; the kept
        answers and the inputs stay."""
        if self.last is not None:
            self.kept.setdefault(*self.last)
        self.last = None
        self.program_state_free()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_state_free(self) -> None:
        pass

    def first_answer(self) -> dict:
        """Set-up and one action: the program's answer on this seed."""
        self.setup()
        return self.run()

    def check(self) -> List[dict]:
        return self.judge(self.kept.values(), self.reference())

    def judge(self, answers: Iterable[dict], want) -> List[dict]:
        raise NotImplementedError

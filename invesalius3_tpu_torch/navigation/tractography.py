"""Tractography: real-time streamline computation around the coil target
(port of invesalius3_tpu/navigation/tractography.py).

Reference: invesalius/data/tractography.py: Trekker (FOD-based
probabilistic tracking) driven by ``ComputeTractsThread`` :230 and
``ComputeTractsACTThread`` :380: seeds in a box around the coil position
(grid_offset :661), tracked and built into renderable bundles.

Two modes, as in the JAX package:

* ``track_streamlines``: deterministic integration over a principal
  direction field (trilinear taps, the sign aligned with the last step);
* ``track_streamlines_probabilistic``: FOD-based tracking.  The FOD is a
  real even-order spherical-harmonic volume (MRtrix convention); each step
  samples K directions in a cone around the heading, evaluates the FOD
  amplitude along each at the nearest voxel, and draws the next direction
  with probability proportional to the amplitude (the Gumbel trick).  A
  streamline dies when no candidate reaches ``min_fod_amp`` or it leaves
  the mask.

All seeds advance in lockstep on ``device`` (the card unless the caller
passes "cpu"): the taps, the FOD fetch, the SH basis and the categorical
draw are tensor ops there.

Departure: the JAX package draws from ``jax.random`` (threefry), which
PyTorch cannot reproduce.  The probabilistic tracker takes its draws as
tensors (``TrackDraws``), made by an explicit ``torch.Generator`` unless the
caller hands them in: the same distributions, not the same draws.  Handed
the JAX package's draws, it follows the JAX package's streamlines.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from invesalius3_tpu_torch.ops.reslice import trilinear

N_INIT_DIRS = 64  # Fibonacci-sphere directions tried for the first heading
LMAX_OF_COEFFS = {1: 0, 6: 2, 15: 4, 28: 6, 45: 8}


def seed_grid(center: np.ndarray, n_seeds: int = 32, radius: float = 1.5,
              seed: int = 0) -> np.ndarray:
    """Random seed cloud around the coil-projected position (reference
    tractography.py grid_offset / seed box); host numpy."""
    rng = np.random.default_rng(seed)
    return center[None, :] + rng.uniform(-radius, radius, (n_seeds, 3))


def _in_mask(maskf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return trilinear(maskf, pos[:, 2], pos[:, 1], pos[:, 0]) > 0.5


def track_streamlines(direction_field, stop_mask, seeds, step_size: float = 0.5,
                      n_steps: int = 200, device=DEFAULT_DEVICE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance all seeds in lockstep through a (Z, Y, X, 3) unit direction
    field ((z, y, x) components) while the (Z, Y, X) ``stop_mask`` holds;
    seeds (N, 3) voxel (z, y, x).  Returns (paths (n_steps+1, N, 3),
    valid (n_steps+1, N)) on ``device``."""
    dev = resolve_device(device)
    field = as_tensor(direction_field, dev, torch.float32)
    comps = [field[..., c] for c in range(3)]
    maskf = as_tensor(stop_mask, dev, torch.float32)
    pos = as_tensor(seeds, dev, torch.float32)
    N = pos.shape[0]
    direction = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(N, 1)
    alive = _in_mask(maskf, pos)
    paths, valids = [pos], [alive]
    for _ in range(n_steps):
        z, y, x = pos[:, 0], pos[:, 1], pos[:, 2]
        d = torch.stack([trilinear(c, x, y, z) for c in comps], dim=1)
        # eigenvectors are sign-ambiguous: keep the previous heading's side
        sign = torch.sign(torch.sum(d * direction, dim=1, keepdim=True))
        d = d * torch.where(sign == 0, 1.0, sign)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-6)
        new_pos = pos + step_size * d
        alive = alive & _in_mask(maskf, new_pos)
        pos = torch.where(alive[:, None], new_pos, pos)
        direction = d
        paths.append(pos)
        valids.append(alive)
    return torch.stack(paths), torch.stack(valids)


# ---------------------------------------------------------------------------
# FOD-based probabilistic tracking (Trekker semantics)
# ---------------------------------------------------------------------------


def n_sh_coefficients(lmax: int) -> int:
    """Coefficient count of a real even-order SH series (MRtrix layout)."""
    return (lmax + 1) * (lmax + 2) // 2


def sh_basis(dirs: torch.Tensor, lmax: int) -> torch.Tensor:
    """Real symmetric spherical-harmonic basis at unit directions ``dirs``
    (..., 3) in (z, y, x) order: (..., n_sh_coefficients(lmax)) in MRtrix
    order (even l ascending, m = -l..l; Y_{l,-m} = sqrt(2) Im(Y_l^m),
    Y_{l,0} = Y_l^0, Y_{l,+m} = sqrt(2) Re(Y_l^m)), from the associated
    Legendre recurrences without the Condon-Shortley phase."""
    z, y, x = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = torch.atan2(y, x)
    P = {(0, 0): torch.ones_like(ct)}
    for m in range(1, lmax + 1):
        P[(m, m)] = P[(m - 1, m - 1)] * (2 * m - 1) * st
    for m in range(0, lmax):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    cols = []
    for l in range(0, lmax + 1, 2):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am) / math.factorial(l + am))
            base = norm * P[(l, am)]
            if m < 0:
                cols.append(math.sqrt(2.0) * base * torch.sin(am * phi))
            elif m == 0:
                cols.append(base)
            else:
                cols.append(math.sqrt(2.0) * base * torch.cos(am * phi))
    return torch.stack(cols, dim=-1)


def _cone_samples(u: torch.Tensor, phi: torch.Tensor, prev_dir: torch.Tensor,
                  max_angle: float) -> torch.Tensor:
    """(N, K, 3) unit directions, uniform in the solid-angle cone of
    half-angle ``max_angle`` around ``prev_dir`` (N, 3): ``u`` (N, K)
    uniform in [0, 1) places cos(theta), ``phi`` (N, K) the azimuth."""
    cos_max = torch.cos(torch.tensor(max_angle, dtype=torch.float32, device=u.device))
    ctheta = 1.0 - u * (1.0 - cos_max)
    stheta = torch.sqrt(torch.clamp(1.0 - ctheta ** 2, min=0.0))
    ref = torch.where(torch.abs(prev_dir[:, 0:1]) < 0.9,
                      torch.tensor([[1.0, 0.0, 0.0]], device=u.device),
                      torch.tensor([[0.0, 1.0, 0.0]], device=u.device))
    e1 = torch.linalg.cross(prev_dir, ref)
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=1, keepdim=True), min=1e-6)
    e2 = torch.linalg.cross(prev_dir, e1)
    return (prev_dir[:, None, :] * ctheta[..., None]
            + e1[:, None, :] * (stheta * torch.cos(phi))[..., None]
            + e2[:, None, :] * (stheta * torch.sin(phi))[..., None])


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


@dataclasses.dataclass
class TrackDraws:
    """The random draws of one probabilistic run: ``gumbel0`` (N, 64) for
    the first heading; per step (n_steps, N, K) ``u`` (uniform in [0, 1),
    cos theta in the cone), ``phi`` (uniform in [0, 2 pi)) and ``gumbel``
    (the categorical draw)."""

    gumbel0: torch.Tensor
    u: torch.Tensor
    phi: torch.Tensor
    gumbel: torch.Tensor

    @classmethod
    def sample(cls, generator: torch.Generator, n_seeds: int, n_steps: int, k: int,
               device) -> "TrackDraws":
        shape = (n_steps, n_seeds, k)
        return cls(gumbel0=_gumbel((n_seeds, N_INIT_DIRS), generator, device),
                   u=torch.rand(shape, generator=generator, device=device),
                   phi=torch.rand(shape, generator=generator, device=device) * (2.0 * math.pi),
                   gumbel=_gumbel(shape, generator, device))


def _init_sphere(device) -> torch.Tensor:
    i0 = np.arange(N_INIT_DIRS)
    phi0 = np.pi * (3.0 - np.sqrt(5.0)) * i0
    z0 = 1.0 - 2.0 * (i0 + 0.5) / N_INIT_DIRS
    r0 = np.sqrt(1.0 - z0 * z0)
    sphere = np.stack([z0, r0 * np.sin(phi0), r0 * np.cos(phi0)], axis=-1)
    return torch.as_tensor(sphere.astype(np.float32), device=device)


def _categorical(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """argmax of logits + gumbel over finite logits (the first index when
    none is finite)."""
    neg_inf = torch.tensor(-math.inf, device=logits.device)
    return torch.argmax(torch.where(torch.isfinite(logits), logits + gumbel, neg_inf), dim=1)


def track_streamlines_probabilistic(
        fod_sh, stop_mask, seeds, generator: Optional[torch.Generator] = None,
        step_size: float = 0.5, n_steps: int = 200, max_angle: float = 0.4,
        min_fod_amp: float = 0.01, data_support_exponent: float = 1.0,
        k_candidates: int = 16, lmax: int = 4, draws: Optional[TrackDraws] = None,
        device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, torch.Tensor]:
    """FOD-amplitude-weighted probabilistic streamline propagation
    (reference tractography.py:630-641 Trekker parameter block) over a
    (Z, Y, X, C) real-SH FOD ((z, y, x) voxel order) within ``stop_mask``.
    The draws come from ``draws`` or, failing that, from ``generator`` (a
    generator on ``device`` seeded 0 when neither is given).  Returns
    (paths (n_steps+1, N, 3), valid (n_steps+1, N)) on ``device``."""
    dev = resolve_device(device)
    C = n_sh_coefficients(lmax)
    fod = as_tensor(fod_sh, dev, torch.float32)
    fod_flat = fod.reshape(-1, fod.shape[-1])[:, :C]
    maskf = as_tensor(stop_mask, dev, torch.float32)
    Z, Y, X = maskf.shape
    pos = as_tensor(seeds, dev, torch.float32)
    N = pos.shape[0]
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        draws = TrackDraws.sample(generator, N, n_steps, k_candidates, dev)
    neg_inf = torch.tensor(-math.inf, device=dev)

    def sample_fod(pos_nk, dirs_nk):
        """FOD amplitude at (N, K) positions along (N, K, 3) directions: the
        nearest voxel's coefficients against the SH basis."""
        zi = torch.clamp(torch.round(pos_nk[..., 0]).int(), 0, Z - 1)
        yi = torch.clamp(torch.round(pos_nk[..., 1]).int(), 0, Y - 1)
        xi = torch.clamp(torch.round(pos_nk[..., 2]).int(), 0, X - 1)
        coef = fod_flat[((zi * Y + yi) * X + xi).long()]  # (N, K, C)
        return torch.sum(coef * sh_basis(dirs_nk, lmax), dim=-1)

    def logits_of(ok, w):
        return torch.where(ok, torch.log(torch.clamp(w, min=1e-30)), neg_inf)

    # the first heading: drawn from the FOD at the seed over a uniform
    # sphere (Trekker samples initial directions until one has support)
    init_dirs = _init_sphere(dev)[None].expand(N, N_INIT_DIRS, 3)
    init_pos = pos[:, None, :].expand(N, N_INIT_DIRS, 3)
    amp0 = torch.clamp(sample_fod(init_pos, init_dirs), min=0.0)
    w0 = torch.where(amp0 >= min_fod_amp, amp0, 0.0) ** data_support_exponent
    pick0 = _categorical(logits_of(w0 > 0, w0), draws.gumbel0.to(dev))
    direction = init_dirs[torch.arange(N, device=dev), pick0]
    alive = _in_mask(maskf, pos) & torch.any(w0 > 0, dim=1)
    paths, valids = [pos], [alive]
    for i in range(n_steps):
        cand = _cone_samples(draws.u[i].to(dev), draws.phi[i].to(dev), direction,
                             max_angle)  # (N, K, 3)
        cand_pos = pos[:, None, :] + step_size * cand
        amp = torch.clamp(sample_fod(cand_pos, cand), min=0.0)
        ok = amp >= min_fod_amp
        w = torch.where(ok, amp, 0.0) ** data_support_exponent
        choice = _categorical(logits_of(ok, w), draws.gumbel[i].to(dev))
        d = cand[torch.arange(N, device=dev), choice]
        new_pos = pos + step_size * d
        alive = alive & torch.any(ok, dim=1) & _in_mask(maskf, new_pos)
        pos = torch.where(alive[:, None], new_pos, pos)
        direction = torch.where(alive[:, None], d, direction)
        paths.append(pos)
        valids.append(alive)
    return torch.stack(paths), torch.stack(valids)


class ComputeTractsThread(threading.Thread):
    """Per-coil-pose tract recomputation (reference tractography.py:230).
    Its tensors live on ``device``; a tract message carries host arrays,
    copied after the run (the copy waits for the card)."""

    def __init__(self, pose_queue: queue.Queue, direction_field: np.ndarray = None,
                 stop_mask: np.ndarray = None, n_tracts_total: int = 64,
                 step_size: float = 0.5, n_steps: int = 120, bus=None,
                 fod_sh: np.ndarray = None, min_fod_amp: float = 0.01,
                 max_angle: float = 0.4, seed: int = 0,
                 world_to_vox=None, device=DEFAULT_DEVICE):
        super().__init__(daemon=True)
        # optional world-mm (x, y, z) -> voxel (z, y, x) converter applied
        # to incoming probe poses (reference tractography.py:661 grid_offset)
        self.world_to_vox = world_to_vox
        if direction_field is None and fod_sh is None:
            raise ValueError("need direction_field (deterministic) or "
                             "fod_sh (probabilistic)")
        if stop_mask is None:
            raise ValueError("stop_mask is required (ACT-style stopping)")
        self.device = resolve_device(device)
        self.pose_queue = pose_queue
        self.direction_field = (None if direction_field is None
                                else as_tensor(direction_field, self.device, torch.float32))
        self.fod_sh = None if fod_sh is None else as_tensor(fod_sh, self.device, torch.float32)
        self.stop_mask = as_tensor(stop_mask, self.device, torch.float32)
        self.n_tracts = n_tracts_total
        self.step_size = step_size
        self.n_steps = n_steps
        self.min_fod_amp = min_fod_amp
        self.max_angle = max_angle
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.bus = bus or events.bus
        self._stop_event = threading.Event()

    def compute_once(self, coil_pos_vox: np.ndarray):
        seeds = seed_grid(np.asarray(coil_pos_vox), self.n_tracts).astype(np.float32)
        if self.fod_sh is not None:
            lmax = LMAX_OF_COEFFS.get(self.fod_sh.shape[-1], 4)
            paths, valid = track_streamlines_probabilistic(
                self.fod_sh, self.stop_mask, seeds, self.generator, self.step_size,
                self.n_steps, self.max_angle, self.min_fod_amp, lmax=lmax,
                device=self.device)
        else:
            paths, valid = track_streamlines(
                self.direction_field, self.stop_mask, seeds, self.step_size,
                self.n_steps, device=self.device)
        return paths.cpu().numpy(), valid.cpu().numpy()

    def run(self):
        while not self._stop_event.is_set():
            try:
                item = self.pose_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            pos = np.asarray(item["probe_pose_img"][:3], float)
            if self.world_to_vox is not None:
                pos = np.asarray(self.world_to_vox(pos), float)
            paths, valid = self.compute_once(pos)
            self.bus.send_message("navigation.tracts", paths=paths, valid=valid,
                                  timestamp=item.get("timestamp"))

    def stop(self):
        self._stop_event.set()

"""The volumes a cell denoises, made on the device from the run's seed.

Each configuration names a generator and its parameters under
``volume``; ``pool`` makes the mix's pool of distinct volumes from one
seed (the same seed gives the same volumes), each with a seed of its own,
and hands them to the host as float32 arrays, as a volume read from disk
comes to the program.  The small parameters (centres, radii, drifts) are
drawn on the host by NumPy, the noise on the device by a seeded
``torch.Generator``, in one call a volume.

- ``blobs``: the synthetic volume of ``scripts/make_test_volume.py:
  make_volume``: Gaussian blobs on a padded plane, each Z slice a crop
  that drifts by a bounded random walk, plus Gaussian noise.
- ``membranes``: the cryo-ET phantom of ``scripts/quality_eval.py:
  make_membranes`` (``make_test_volume.py --pattern membranes``): curved
  membrane sheets and filaments drifting with Z on a grey background,
  plus Gaussian noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = (1 << 64) - 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A NumPy generator for ``seed`` and a stream of it."""
    return np.random.default_rng([seed & _MASK, *stream])


def _torch_generator(r: np.random.Generator, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(r.integers(1 << 62)))
    return g


def blobs(p: dict, shape, r: np.random.Generator, device) -> torch.Tensor:
    n, h, w = shape
    pad, k = int(p["pad"]), int(p["blobs"])
    cy = r.uniform(pad, h + pad, k)
    cx = r.uniform(pad, w + pad, k)
    rad = r.uniform(*p["radius"], k)
    amp = r.uniform(*p["amplitude"], k)
    steps = r.uniform(-p["drift"], p["drift"], (n, 2))
    gen = _torch_generator(r, device)

    def profile(centres, size):
        x = torch.arange(size, dtype=torch.float64, device=device)
        c = torch.as_tensor(centres, device=device)[:, None]
        s = torch.as_tensor(rad, device=device)[:, None]
        return torch.exp(-(x - c) ** 2 / (2 * s * s))

    a = torch.as_tensor(amp, device=device)[:, None, None]
    base = (a * profile(cy, h + 2 * pad)[:, :, None]
            * profile(cx, w + 2 * pad)[:, None, :]).sum(0)
    oy = ox = float(pad)
    iy, ix = [], []
    for z in range(n):
        iy.append(int(round(oy)))
        ix.append(int(round(ox)))
        oy = min(max(oy + steps[z, 0], 0), 2 * pad - 1)
        ox = min(max(ox + steps[z, 1], 0), 2 * pad - 1)
    rows = torch.as_tensor(iy, device=device)[:, None] + torch.arange(h, device=device)
    cols = torch.as_tensor(ix, device=device)[:, None] + torch.arange(w, device=device)
    vol = base[rows[:, :, None], cols[:, None, :]].float()
    return vol.add_(torch.randn(vol.shape, generator=gen, device=device),
                    alpha=float(p["noise"]))


def membranes(p: dict, shape, r: np.random.Generator, device) -> torch.Tensor:
    n, h, w = shape
    drift = p["drift"]
    dz = np.cumsum(r.uniform(-drift, drift, n))
    dy = np.cumsum(r.uniform(-drift, drift, n))
    mem = [(r.uniform(0.1 * h, 0.9 * h), r.uniform(3, 12),
            r.uniform(0.5 * w, 2.0 * w), r.uniform(0, 2 * math.pi),
            r.uniform(1.2, 2.5), r.uniform(60, 140), r.uniform(2 * n, 6 * n))
           for _ in range(int(p["membranes"]))]
    fil = [(r.uniform(0, h), r.uniform(0, w), r.uniform(-1.5, 1.5),
            r.uniform(-1.5, 1.5), r.uniform(1.5, 3.0), r.uniform(80, 160))
           for _ in range(int(p["filaments"]))]
    gen = _torch_generator(r, device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    z = torch.arange(n, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    vol = torch.full((n, h, w), float(p["background"]), device=device)
    for y0, amp, wl, ph, thick, bright, zwl in mem:
        yc = (y0 + amp * torch.sin(2 * math.pi * xs[None, :] / wl + ph
                                   + 2 * math.pi * z[:, None] / zwl)
              + t(dy)[:, None])
        vol += bright * torch.exp(-(ys[None, :, None] - yc[:, None, :]) ** 2
                                  / (2 * thick * thick))
    for cy, cx, vy, vx, rad, bright in fil:
        py = torch.remainder(cy + vy * z + t(dy), h)
        px = torch.remainder(cx + vx * z + t(dz), w)
        gy = torch.exp(-(ys[None, :] - py[:, None]) ** 2 / (2 * rad * rad))
        gx = torch.exp(-(xs[None, :] - px[:, None]) ** 2 / (2 * rad * rad))
        vol += bright * gy[:, :, None] * gx[:, None, :]
    return vol.add_(torch.randn(vol.shape, generator=gen, device=device),
                    alpha=float(p["noise"]))


GENERATORS = {"blobs": blobs, "membranes": membranes}


def volume(config: dict, seed: int, index: int, device) -> torch.Tensor:
    """Volume ``index`` of the pool of ``seed``, float32 on ``device``."""
    p = config["volume"]
    return GENERATORS[p["generator"]](p, tuple(p["shape"]), rng(seed, index),
                                      device)


def pool(config: dict, traffic: dict, seed: int, device) -> list[np.ndarray]:
    """The mix's pool of distinct volumes on the host, float32."""
    return [volume(config, seed, i, device).cpu().numpy()
            for i in range(int(traffic["pool"]))]


def sampled(traffic: dict, seed: int) -> int:
    """The pool index whose every output in the window is compared with
    the reference."""
    return int(rng(seed, 1 << 30).integers(int(traffic["pool"])))

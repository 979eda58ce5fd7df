"""Input noise estimation and the ``--flow_presmooth auto`` policy.

The port's copy of ``flowdenoising_tpu/core/noise.py`` (NumPy only, the
same estimate, threshold and sigma), so the two packages decide alike.

``FlowConfig.presmooth`` suppresses flow-estimation noise (axis_filter
``_estimation_stack``); QUALITY.md measures when it pays: at noise sigma >=
~30 on both volume families presmooth=1.5 beats the exact-operand parity
mode on SSIM (and the cv2 reference), while on the low-noise membranes tier
it costs ~0.3 dB PSNR (fine structure blurs out of the estimation operands).

``auto`` therefore enables presmooth only when the input is CLEARLY noisy:
estimated noise >= _REL_THRESHOLD of the estimated signal spread.  Tier
calibration (scripts/quality_eval.py volumes):

    membranes n15 rel=0.31 (presmooth loses)   -> off
    blobs     n30 rel=0.24 (small win)         -> off (conservative)
    blobs     n60 rel=0.48 (clear win)         -> on
    membranes n30 rel=0.61, n60 rel=1.23 (win) -> on

Round-5 boundary stress (tiers ENGINEERED at rel 0.40 / 0.50, QUALITY.md):
the decision boundary is content-ambiguous -- at rel=0.50 presmooth WINS
on blobs (+0.13 dB PSNR, +0.025 SSIM) but costs PSNR on membranes
(-0.35 dB, +0.002 SSIM); at rel=0.40 both picks are PSNR-equal (blobs)
or off-wins (membranes, +0.39 dB).  No threshold separates the families
at the same rel, so 0.45 stays put between the measured regimes; the
worst boundary penalty of the auto pick is 0.35 dB PSNR with SSIM never
worse than the alternative (tests/test_noise.py pins this).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from flowdenoising_tpu_torch.config import FilterConfig

_REL_THRESHOLD = 0.45
_AUTO_SIGMA = 1.5


def _noise_and_spread(vol, n_slices: int = 5):
    """(noise std, total std) over evenly sampled Z slices — one pass over
    the planes (a memory-mapped >RAM volume pages each sampled plane in
    exactly once)."""
    n = vol.shape[0]
    zs = np.unique(np.linspace(0, n - 1, min(n_slices, n)).astype(int))
    vals, slices = [], []
    for z in zs:
        s = np.asarray(vol[z], np.float64)
        slices.append(s)
        if s.shape[0] < 3 or s.shape[1] < 3:
            continue
        lap = (4 * s[1:-1, 1:-1]
               - 2 * (s[:-2, 1:-1] + s[2:, 1:-1]
                      + s[1:-1, :-2] + s[1:-1, 2:])
               + (s[:-2, :-2] + s[:-2, 2:] + s[2:, :-2] + s[2:, 2:]))
        vals.append(np.sqrt(np.pi / 2) / 6 * np.mean(np.abs(lap)))
    sigma_n = float(np.mean(vals)) if vals else 0.0
    total_std = float(np.std(np.stack(slices))) if slices else 0.0
    return sigma_n, total_std


def estimate_noise(vol, n_slices: int = 5) -> float:
    """Immerkaer fast noise estimate (std of i.i.d. pixel noise), averaged
    over evenly sampled Z slices.  Within ~1% of the true sigma on the
    quality-tier volumes; host-side, touches only the sampled planes."""
    return _noise_and_spread(vol, n_slices)[0]


def resolve_auto_presmooth(vol, cfg: FilterConfig) -> FilterConfig:
    """Return ``cfg`` with presmooth set by the measured-noise policy."""
    sigma_n, total_std = _noise_and_spread(vol)
    # signal spread of the noisy volume, noise contribution removed
    signal = np.sqrt(max(total_std ** 2 - sigma_n ** 2, 1e-12))
    rel = sigma_n / signal if signal > 0 else 0.0
    ps = _AUTO_SIGMA if rel >= _REL_THRESHOLD else 0.0
    logging.info(f"auto flow_presmooth: noise est {sigma_n:.2f}, signal "
                 f"spread {signal:.2f} (rel {rel:.2f}) -> presmooth={ps}")
    return dataclasses.replace(
        cfg, flow=dataclasses.replace(cfg.flow, presmooth=ps))

"""Gaussian tap construction with reference parity.

The reference builds its 1-D taps by filtering a discrete delta through
``scipy.ndimage.gaussian_filter1d`` inside a grow-until-two-zeros loop
(reference ``flowdenoising.py:34-45``).  The fixed point of that loop is
scipy's sampled-and-normalized Gaussian at the default truncation of
4 sigma: radius ``r = int(4*sigma + 0.5)`` and taps

    phi[i] = exp(-0.5 * (i - r)^2 / sigma^2),   i = 0..2r,  phi /= phi.sum()

computed here in float64 (a copy of ``flowdenoising_tpu/kernels.py``).
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel_radius(sigma: float, truncate: float = 4.0) -> int:
    """scipy.ndimage truncation law: radius = int(truncate * sigma + 0.5)."""
    return int(truncate * float(sigma) + 0.5)


def get_gaussian_kernel(sigma: float = 1.0, truncate: float = 4.0) -> np.ndarray:
    """Odd-length normalized Gaussian taps (float64, length
    ``2*int(truncate*sigma + 0.5) + 1``: sigma=2 -> 17 taps)."""
    sigma = float(sigma)
    if sigma <= 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    r = gaussian_kernel_radius(sigma, truncate)
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x * x) / (sigma * sigma))
    phi /= phi.sum()
    return phi


def get_gaussian_kernels(sigmas, truncate: float = 4.0) -> list[np.ndarray]:
    """Per-axis taps for (sigma_z, sigma_y, sigma_x)."""
    return [get_gaussian_kernel(s, truncate) for s in sigmas]

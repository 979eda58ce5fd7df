"""Configuration dataclasses for the denoising pipeline.

Field-for-field the configuration of the JAX package
(``flowdenoising_tpu/config.py``), with the same defaults, so one setting
means the same thing in both packages, and the port runs every setting.

This system has no learned weights: what a run carries is its
configuration plus the Gaussian taps derived from it.  ``from_reference``
turns a JAX ``FilterConfig`` or ``FlowConfig`` into the port's, by reading
its fields, without importing JAX.
"""

from __future__ import annotations

import dataclasses
import enum


class Boundary(str, enum.Enum):
    """Boundary handling for the filtered axis.

    WRAP      -- modular indexing (the reference main CLI).
    MEAN      -- pad with the volume mean (the reference's sequential variant).
    REPLICATE -- clamp to the edge slice.
    """

    WRAP = "wrap"
    MEAN = "mean"
    REPLICATE = "replicate"


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Farneback optical-flow estimator parameters (see the JAX package's
    ``FlowConfig`` for the meaning of each field)."""

    levels: int = 3
    winsize: int = 5
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    pyr_scale: float = 0.5
    use_initial_flow: bool = True
    min_size: int = 32
    dtype: str = "float32"
    precision: str = "float32"
    # Sampling bound in pixels (flows are clamped to +-D when sampling);
    # None samples at the exact, unclamped displacement.
    max_displacement: int | None = 8
    # The JAX package's choice of TPU sampler; the port has one sampler per
    # device, so every value means the same here.
    sampler: str = "auto"
    tap_mode: str = "solve"
    adjacent_displacement: int | None = 4
    symmetric_adjacent: bool = False
    presmooth: float = 0.0

    def __post_init__(self):
        if self.tap_mode not in ("solve", "compose"):
            raise ValueError(
                f"unknown tap_mode {self.tap_mode!r}: expected 'solve' or "
                "'compose'")
        for name in ("dtype", "precision"):
            if getattr(self, name) not in ("float32", "bfloat16"):
                raise ValueError(f"unknown {name} {getattr(self, name)!r}: "
                                 "expected 'float32' or 'bfloat16'")

    def clamped_levels(self, height: int, width: int) -> int:
        """Number of pyramid levels actually used for an image size
        (OpenCV's loop: stop before a level narrower than ``min_size``)."""
        k = 0
        scale = 1.0
        while k < self.levels:
            scale *= self.pyr_scale
            if width * scale < self.min_size or height * scale < self.min_size:
                break
            k += 1
        return k


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Separable OF-compensated Gaussian filter parameters."""

    sigma: tuple[float, float, float] = (2.0, 2.0, 2.0)  # (Z, Y, X)
    boundary: Boundary = Boundary.WRAP
    use_flow: bool = True     # False == -n / --no_OF
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    # Output slices are processed in slabs of this many slices; None = the
    # whole axis at once.
    slab_size: int | None = None


def from_reference(cfg):
    """The port's counterpart of a JAX ``FilterConfig`` or ``FlowConfig``.

    Reads the fields by name (duck typing), so the JAX package is never
    imported here.
    """
    if hasattr(cfg, "flow"):
        return FilterConfig(
            sigma=tuple(float(s) for s in cfg.sigma),
            boundary=Boundary(getattr(cfg.boundary, "value", cfg.boundary)),
            use_flow=bool(cfg.use_flow),
            flow=from_reference(cfg.flow),
            slab_size=cfg.slab_size)
    return FlowConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(FlowConfig)})

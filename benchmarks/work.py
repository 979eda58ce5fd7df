"""The work a layer's algorithm needs for one volume, counted from shapes.

A roofline share is the least time the card could take for that work --
the larger of its bytes at the HBM rate and its operations at the float32
rate -- over the layer's measured device time.  The counts take only the
volume's shape and the configuration, never launches or kernels, so a
change that fuses taps, levels or layers is held to the same count, and no
implementation can read above 100%: each input byte is counted read once,
each output byte written once, and only the operations the algorithm
needs.

Per pass (Z, Y, X: the volume permuted so the filtered axis leads; N
output planes of H x W, a padded stack of N + 2 ks2 planes):

- tap solve: every solve (2 ks2 of N planes in solve mode; 2, or 1 with
  symmetric adjacent flows, of N + 2 ks2 - 1 planes in compose mode) runs
  ``iterations`` Farneback iterations at every pyramid level, 137 flop a
  pixel an iteration at winsize 5; bytes: the stack's pyramid read once
  and each solve's level-0 flow written once.
- expansion pyramid: the stack read once and each level's five
  coefficient planes written once; operations: each level's separable
  pre-blur at full resolution and the expansion's nine separable filters
  and five combinations (the resizes between are the resize layer's).
- compose pass: 2 ks2 taps of 42 flop an output pixel; bytes: the
  adjacent flows and the stack read once, the accumulator read and
  written once.
"""

from __future__ import annotations

import dataclasses

from benchmarks.reference.plain import (
    LAYOUTS, clamped_levels, level_smoothing_taps, pyramid_sizes)

# Published peaks of one H100 SXM at its 700 W limit: HBM bytes/s, and
# float32 flop/s outside the tensor cores (no layer here is a matrix
# product).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32 = 4

# Farneback, per pixel and iteration: phase 1 (sample the reference's
# expansion at the displaced position, form M) and phase 2 (separable box
# sum of five channels, scale, 2x2 solve).
UM_FLOPS = 70
# K-compose-run's tap, per output pixel: two sample footprints, 2 + 1
# sampled values, the flow add, the weighted add.
COMPOSE_TAP_FLOPS = 2 * 10 + 2 * 6 + 2 + 6 + 2


def uf_flops(winsize: int) -> int:
    return 5 * 2 * (2 * (winsize // 2) + 1) + 5 + 12


def umuf_flops(winsize: int) -> int:
    return UM_FLOPS + uf_flops(winsize)


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    @property
    def least_ms(self) -> float:
        """The least time on the card, ms."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S,
                         self.flops / F32_FLOPS_PER_S)

    @property
    def bound(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / F32_FLOPS_PER_S else "operations")


def passes(shape, sigma):
    """(n, h, w, ks2) of each pass: output planes, plane, tap radius."""
    for axis, layout in enumerate(LAYOUTS):
        n, h, w = (shape[ax] for ax in layout)
        yield n, h, w, int(4.0 * float(sigma[axis]) + 0.5)


def _levels(flow: dict, h: int, w: int):
    return pyramid_sizes(h, w, clamped_levels(flow, h, w), flow["pyr_scale"])


def tap_solve(shape, sigma, flow: dict) -> Work:
    total = Work()
    for n, h, w, ks2 in passes(shape, sigma):
        area = sum(hk * wk for hk, wk in _levels(flow, h, w))
        stack = n + 2 * ks2
        if flow["tap_mode"] == "solve":
            solves, planes = 2 * ks2, n
        else:
            solves, planes = 1 if flow["symmetric_adjacent"] else 2, stack - 1
        total += Work(
            bytes=F32 * (stack * area * 5 + solves * planes * h * w * 2),
            flops=solves * planes * area * flow["iterations"]
            * umuf_flops(flow["winsize"]))
    return total


def expansion(shape, sigma, flow: dict) -> Work:
    taps = 2 * flow["poly_n"] + 1
    total = Work()
    for n, h, w, ks2 in passes(shape, sigma):
        stack = n + 2 * ks2
        sizes = _levels(flow, h, w)
        area = sum(hk * wk for hk, wk in sizes)
        blur = sum(2 * 2 * len(level_smoothing_taps(k, flow["pyr_scale"]))
                   for k in range(len(sizes)))
        total += Work(bytes=F32 * stack * (h * w + 5 * area),
                      flops=stack * (blur * h * w + (9 * 2 * taps + 9) * area))
    return total


def compose(shape, sigma, flow: dict) -> Work:
    links = 1 if flow["symmetric_adjacent"] else 2
    total = Work()
    for n, h, w, ks2 in passes(shape, sigma):
        stack = n + 2 * ks2
        total += Work(
            bytes=F32 * h * w * (links * (stack - 1) * 2 + stack + 2 * n),
            flops=2 * ks2 * COMPOSE_TAP_FLOPS * n * h * w)
    return total

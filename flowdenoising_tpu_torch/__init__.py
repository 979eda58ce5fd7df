"""FlowDenoising on PyTorch and CUDA: optical-flow-compensated Gaussian
denoising of volumetric microscopy data on an NVIDIA Hopper GPU.

The port of the JAX package ``flowdenoising_tpu`` (kept beside it as the
reference).  It imports ``torch`` and neither ``jax`` nor
``flowdenoising_tpu``.  Its main path is the flow denoise, in the solve and
the compose tap modes; ``denoise`` runs on the input tensor's device, or on
CUDA for an array unless ``device="cpu"`` is passed:

- ``flowdenoising_tpu_torch.core``  -- per-axis passes and the Z -> Y -> X
  pipeline (``denoise``; ``denoise_many`` for batches of volumes; the
  disk-streamed ``stream.denoise_streamed``; the slab memory model), the
  auto displacement probe and the noise policy;
- ``flowdenoising_tpu_torch.ops``   -- resize, blur, warp, the compose
  taps and Farneback flow: the math, the plain PyTorch version of each
  hand-written CUDA kernel, and the one choice between the two
  (``ops.device.use_kernel``: the kernel on a CUDA tensor, the plain
  version on a CPU one).  ``ops.cuda`` only launches the kernels: K-umuf,
  K-umuf-split, K-um and K-uf (Farneback iterations), K-sample and
  K-sample-split (tap warps), K-compose, K-compose-run and
  K-compose-run-split (compose taps), K-polyexp and K-pyr-blur (the
  expansion pyramid), and K-resize;
- ``flowdenoising_tpu_torch.utils`` -- pass-boundary checkpoints, the
  ``-v 2`` stage reports, PSNR/SSIM (``metrics``), device traces
  (``tracing``), logging and progress;
- ``flowdenoising_tpu_torch.io``    -- MRC2014 and TIFF volume I/O;
- ``flowdenoising_tpu_torch.cli``   -- the reference-compatible CLI.
"""

from flowdenoising_tpu_torch.version import __version__
from flowdenoising_tpu_torch.kernels import get_gaussian_kernel
from flowdenoising_tpu_torch.config import (
    Boundary, FilterConfig, FlowConfig, from_reference)
from flowdenoising_tpu_torch.ops.warp import warp_slices
from flowdenoising_tpu_torch.ops.farneback import farneback_flow
from flowdenoising_tpu_torch.core.pipeline import (
    denoise, denoise_many, gaussian_denoise)
from flowdenoising_tpu_torch.core.autodisp import resolve_auto_displacement
from flowdenoising_tpu_torch.core.noise import (
    estimate_noise, resolve_auto_presmooth)

__all__ = [
    "__version__",
    "get_gaussian_kernel",
    "Boundary",
    "FilterConfig",
    "FlowConfig",
    "from_reference",
    "warp_slices",
    "farneback_flow",
    "denoise",
    "denoise_many",
    "gaussian_denoise",
    "resolve_auto_displacement",
    "estimate_noise",
    "resolve_auto_presmooth",
]

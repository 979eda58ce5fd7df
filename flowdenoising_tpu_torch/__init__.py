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
- ``flowdenoising_tpu_torch.ops``   -- resize, blur, warp and Farneback
  flow, with the hand-written CUDA kernels K-umuf (one Farneback iteration),
  K-sample (the solve-mode tap warp), K-compose (the compose-mode tap), and
  K-um and K-uf (the two halves of an iteration, for the ``-v 2`` report)
  under ``ops.cuda`` and their plain PyTorch versions beside them;
- ``flowdenoising_tpu_torch.utils`` -- pass-boundary checkpoints, the
  ``-v 2`` stage reports, logging and progress;
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
]

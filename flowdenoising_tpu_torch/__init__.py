"""FlowDenoising on PyTorch and CUDA: optical-flow-compensated Gaussian
denoising of volumetric microscopy data on an NVIDIA Hopper GPU.

The port of the JAX package ``flowdenoising_tpu`` (kept beside it as the
reference).  It imports ``torch`` and neither ``jax`` nor
``flowdenoising_tpu``.  Its main path is the solve-mode flow denoise:

- ``flowdenoising_tpu_torch.core``  -- per-axis passes and the Z -> Y -> X
  pipeline;
- ``flowdenoising_tpu_torch.ops``   -- resize, blur, warp and Farneback
  flow, with the hand-written CUDA kernels K-umuf (one Farneback iteration)
  and K-sample (the tap warp) under ``ops.cuda`` and their plain PyTorch
  versions beside them;
- ``flowdenoising_tpu_torch.io``    -- MRC2014 and TIFF volume I/O;
- ``flowdenoising_tpu_torch.cli``   -- the reference-compatible CLI.
"""

from flowdenoising_tpu_torch.version import __version__
from flowdenoising_tpu_torch.kernels import get_gaussian_kernel
from flowdenoising_tpu_torch.config import (
    Boundary, FilterConfig, FlowConfig, from_reference)
from flowdenoising_tpu_torch.ops.warp import warp_slices
from flowdenoising_tpu_torch.ops.farneback import farneback_flow
from flowdenoising_tpu_torch.core.pipeline import denoise, gaussian_denoise

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
    "gaussian_denoise",
]

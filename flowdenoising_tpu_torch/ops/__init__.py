"""Tensor operations: resize, blur, warp, the compose taps and Farneback
flow.  Each operation that has a hand-written CUDA kernel runs it on a CUDA
tensor and its plain PyTorch version, kept here, on a CPU tensor; the
choice is ``ops.device.use_kernel``'s alone.  ``ops.cuda`` launches the
kernels and imports nothing of this layer."""

from flowdenoising_tpu_torch.ops.warp import warp_slices
from flowdenoising_tpu_torch.ops.resize import (
    area_resize_matrix, linear_resize_matrix, resize_area, resize_linear)
from flowdenoising_tpu_torch.ops.blur import (
    box_blur, gaussian_blur, opencv_gaussian_taps)
from flowdenoising_tpu_torch.ops.farneback import farneback_flow, poly_expand

__all__ = [
    "warp_slices",
    "resize_linear",
    "resize_area",
    "linear_resize_matrix",
    "area_resize_matrix",
    "gaussian_blur",
    "box_blur",
    "opencv_gaussian_taps",
    "farneback_flow",
    "poly_expand",
]

"""Per-axis passes and the three-pass pipeline."""

from flowdenoising_tpu_torch.core.axis_filter import (
    gaussian_pass, of_pass, pad_stack)
from flowdenoising_tpu_torch.core.pipeline import denoise, gaussian_denoise

__all__ = ["gaussian_pass", "of_pass", "pad_stack", "denoise",
           "gaussian_denoise"]

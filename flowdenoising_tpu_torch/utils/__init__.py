"""Logging, progress, phase timing and provenance helpers."""

from flowdenoising_tpu_torch.utils.logging import (
    log_volume_stats, setup_logging)
from flowdenoising_tpu_torch.utils.progress import ProgressReporter
from flowdenoising_tpu_torch.utils.fingerprint import file_fingerprint
from flowdenoising_tpu_torch.utils.profiler import PhaseProfiler

__all__ = ["setup_logging", "log_volume_stats", "ProgressReporter",
           "file_fingerprint", "PhaseProfiler"]

"""Device tracing helpers, the counterpart of
``flowdenoising_tpu/utils/tracing.py``:

    from flowdenoising_tpu_torch.utils.tracing import annotate, device_trace
    with device_trace("/tmp/fdt-trace"):
        with annotate("my_phase"):
            denoise(vol, cfg)

``device_trace`` writes one Chrome trace (``chrome://tracing``, Perfetto)
of the block into ``log_dir``: CPU operations, and the CUDA kernels where
there is a card, through ``utils.trace_report.traced_run``.  Where the JAX
package's warns and traces nothing when its backend refuses to profile,
this one raises.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from flowdenoising_tpu_torch.utils.trace_report import traced_run

__all__ = ["annotate", "device_trace"]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block into a new trace file in ``log_dir``
    (created if missing); yields a dict that holds the file's path under
    "path" once the block ends."""
    os.makedirs(log_dir, exist_ok=True)
    with traced_run(log_dir=log_dir) as state:
        yield state
    logging.info(f"device trace written to {state['path']}")


@contextlib.contextmanager
def annotate(name: str):
    """A named range in traces: a ``torch.profiler`` range (on the CPU
    timeline, and on the device's where there is a card), and an NVTX range
    where CUDA is available."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()

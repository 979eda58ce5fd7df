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

``span`` is the program's own range: every range the port opens goes
through it.  While a profiler runs (``torch.profiler``, or the legacy
profilers, ``emit_nvtx`` included) it is a ``torch.profiler`` range, on the
host's timeline and, around launches, on the device's; otherwise it is one
check and nothing else.  The names:

- ``OFE_expansion``: each expansion pyramid (``ops.farneback:
  polyexp_pyramid``);
- ``OFE_solve``: each pyramid level's iterations of a flow solve (K-umuf,
  K-umuf-split);
- ``warping``: each tap warp (K-sample, K-sample-split);
- ``fdt.compose``: each compose pass (K-compose-run, K-compose-run-split);
- ``fdt.resize``: each separable resize (``ops.resize``: K-resize or the
  dense products);
- ``fdt.pass``: each pass of ``core.pipeline`` (Z, Y, X);
- ``fdt.drain.<site>``: each call that holds the host on a CUDA device,
  a copy from pageable host memory (which syncs the stream) or the memory
  query ``cudaMemGetInfo``: ``input``
  (an array taken to the device, ``ops.device.as_tensors``),
  ``pad_index`` (``core.axis_filter.pad_stack``), ``blur_index``
  (``ops.blur.corr1d``: the pyramid's plain chain, on a CPU or bfloat16
  stack, and the presmooth blur), ``resize_matrix`` (K-resize's tap
  table of an axis, at its shape's first use on a device; each weight
  matrix of a bfloat16 resize), ``mem_info`` (``core.memory.device_budget``), ``pad_fill``
  (the MEAN boundary's fill value from the host).  On the card one span is
  one drain, so a trace's count of them is the count of drains.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

__all__ = ["annotate", "device_trace"]

EXPANSION_RANGE = "OFE_expansion"
SOLVE_RANGE = "OFE_solve"
WARP_RANGE = "warping"
COMPOSE_RANGE = "fdt.compose"
RESIZE_RANGE = "fdt.resize"
PASS_RANGE = "fdt.pass"
DRAIN_PREFIX = "fdt.drain."

# true while any autograd profiler records on this thread (the kineto
# profiler of torch.profiler, and the legacy ones, emit_nvtx's included)
_profiler_enabled = torch._C._autograd._profiler_enabled
_NOTHING = contextlib.nullcontext()


def span(name: str):
    """A context manager: the ``torch.profiler`` range ``name`` while a
    profiler records (an NVTX range under ``emit_nvtx``), else a shared
    no-op context -- no range object, no NVTX call, no allocation."""
    if not _profiler_enabled():
        return _NOTHING
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block into a new trace file in ``log_dir``
    (created if missing); yields a dict that holds the file's path under
    "path" once the block ends."""
    # imported here: trace_report reads the range names above
    from flowdenoising_tpu_torch.utils.trace_report import traced_run

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

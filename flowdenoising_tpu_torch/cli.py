"""Command-line interface, flag-compatible with the JAX package's CLI
(``flowdenoising_tpu/cli.py``) and the reference ``flowdenoising.py``.

Usage:
    python -m flowdenoising_tpu_torch -i vol.mrc -o denoised.mrc -s 2 2 2

The port runs the flow denoise in both tap modes (``--tap_flow solve``,
the default, and ``--tap_flow compose`` with ``--symmetric_adjacent``) and
``-n``, in float32 or in the bf16 fast mode (``--dtype bfloat16
--precision bfloat16``), in memory (each pass in windows sized for the
card where the whole axis does not fit), or streamed from disk
(``--stream``), with per-pass checkpoints (``--checkpoint_dir``) that a
rerun resumes from; on one device, sharded over the first N
(``--devices N``), or over processes, one per GPU
(``--coordinator HOST:PORT --num_hosts N --host_id I``: NCCL on CUDA,
gloo with ``--device cpu``).  The displacement bound is
probed from the volume by default (``--max_displacement auto``), and flows
may be estimated from a presmoothed copy (``--flow_presmooth``).  ``-v 2``
logs the per-stage device time: measured from a ``torch.profiler`` trace
of the run on the card, reconstructed from per-op timings where the trace
has no device event.  Every flag of a feature not yet ported exits with a
message naming its ROADMAP item; none is ignored.  ``--device`` picks the
device: ``cuda`` (the default) runs the CUDA kernels and fails without a
CUDA device; ``cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.utils.fingerprint import file_fingerprint
from flowdenoising_tpu_torch.utils.logging import log_volume_stats, setup_logging
from flowdenoising_tpu_torch.utils.profiler import PhaseProfiler

SIGMA = 2.0
OF_LEVELS = 3
OF_WINDOW_SIZE = 5
MAX_DISPLACEMENT = 8


def int_or_str(text):
    try:
        return int(text)
    except ValueError:
        return text


def float_or_str(text):
    try:
        return float(text)
    except ValueError:
        return text


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-i", "--input", type=int_or_str, default="./volume.mrc",
                   help="Input a MRC-file or a multi-image TIFF-file")
    p.add_argument("-o", "--output", type=int_or_str, default="./denoised_volume.mrc",
                   help="Output a MRC-file or a multi-image TIFF-file")
    p.add_argument("-s", "--sigma", nargs="+", default=(SIGMA, SIGMA, SIGMA),
                   help="Gaussian sigma for each dimension in the order (Z, Y, X)")
    p.add_argument("-l", "--levels", type=int_or_str, default=OF_LEVELS,
                   help="Number of levels of the Gaussian pyramid used by the optical flow estimator")
    p.add_argument("-w", "--winsize", type=int_or_str, default=OF_WINDOW_SIZE,
                   help="Size of the window used by the optical flow estimator")
    p.add_argument("-v", "--verbosity", type=int_or_str, default=0, help="Verbosity level")
    p.add_argument("-n", "--no_OF", action="store_true",
                   help="Disable optical flow compensation")
    p.add_argument("-m", "--memory_map", action="store_true",
                   help="Enable memory-mapping of MRC input")
    p.add_argument("-p", "--number_of_processes", type=int_or_str, default=None,
                   help="Accepted for reference compatibility; the work runs on one device")
    p.add_argument("--recompute_flow", action="store_true",
                   help="Disable the use of adjacent optical flow fields")
    p.add_argument("--show_fingerprint", action="store_true",
                   help="Show a hash of this file")
    p.add_argument("--use_GPU", action="store_true",
                   help="Accepted for reference compatibility; --device picks the device")
    p.add_argument("--use_threads", action="store_true",
                   help="Accepted for reference compatibility; the work runs on one device")
    p.add_argument("--boundary", choices=[b.value for b in Boundary], default=Boundary.WRAP.value,
                   help="Boundary mode along the filtered axis (reference main CLI: wrap; "
                        "sequential variant: mean)")
    p.add_argument("--slab_size", type=int, default=None,
                   help="Process each pass in slabs of this many output "
                        "slices (default: the whole axis where the card's "
                        "memory model allows, else the largest slab that "
                        "fits)")
    p.add_argument("--devices", type=int, default=None,
                   help="Shard the passes over the first N CUDA cards (with "
                        "--device cpu: N shards of the CPU), bit-identical to "
                        "one device; default one device")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="Optical-flow pass dtype: bfloat16 carries the "
                        "stack, the expansion pyramid, the tap flows and the "
                        "accumulator in bf16 between kernels (the output is "
                        "float32; not with --max_displacement 0, ROADMAP A9)")
    p.add_argument("--precision", choices=["float32", "bfloat16"], default="float32",
                   help="Flow inner-pass precision: bfloat16 samples the "
                        "reference expansion (and, in compose mode, the "
                        "link flows and neighbours) rounded to bf16, in the "
                        "kernels' packed forms; with a displacement bound "
                        "only.  --dtype bfloat16 --precision bfloat16 is the "
                        "fast mode")
    p.add_argument("--tap_flow", choices=["solve", "compose"], default="solve",
                   help="Per-tap flow strategy: 'solve' = one Farneback solve per "
                        "tap pair; 'compose' = one solve per adjacent slice pair "
                        "and direction, farther taps' flows composed from them")
    p.add_argument("--max_displacement", type=int_or_str, default=None,
                   help="Per-tap flow sampling bound in pixels; motions beyond it "
                        "are clamped during sampling.  Default 'auto': probe the "
                        "volume's motion and pick the smallest bound that loses "
                        "no tracked motion (core/autodisp.py); with -n the "
                        f"fixed {MAX_DISPLACEMENT}.  An integer fixes the bound; "
                        "0 = no bound (exact sampling)")
    p.add_argument("--flow_presmooth", type=float_or_str, default=0.0,
                   help="Estimate flows from a copy of the volume pre-smoothed "
                        "in-plane with this Gaussian sigma (px); tap warps still "
                        "sample the raw volume.  0 = off; 'auto' enables it "
                        "when the input is clearly noisy (core/noise.py)")
    p.add_argument("--symmetric_adjacent", action="store_true",
                   help="Compose mode: take the backward adjacent flows as the "
                        "negated forward ones (one adjacent solve per pass "
                        "instead of two)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Persist the volume after each completed axis pass here and "
                        "resume from the last completed pass on restart")
    p.add_argument("--stream", action="store_true",
                   help="Disk-streamed passes for volumes larger than host "
                        "RAM: the volume stays memory-mapped on disk and "
                        "each pass streams axis slabs through the device "
                        "(scratch memmaps ping-pong between passes; "
                        "bitwise-identical to the in-memory pipeline)")
    p.add_argument("--tiff_quantize", action="store_true",
                   help="Quantize TIFF output like the reference sequential "
                        "variant: uint8 if max < 256 else uint16")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's torch.distributed store; "
                        "launch one CLI process per GPU (or CPU rank) with "
                        "matching --num_hosts/--host_id.  Each process reads "
                        "only its Z planes of the input and writes only its "
                        "planes of the output (shared storage, MRC only)")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Total number of distributed CLI processes")
    p.add_argument("--host_id", type=int, default=None,
                   help="This process's rank in [0, num_hosts)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions")
    return p


def _refuse_unported(args) -> None:
    """Exit, naming the ROADMAP item, on any flag of an unported feature."""
    if (args.dtype == "bfloat16" and not args.no_OF
            and args.max_displacement == 0):
        raise SystemExit("--dtype bfloat16 with --max_displacement 0 (no "
                         "bound) is not yet ported (ROADMAP A9)")


def _check_distributed(args, auto_disp: bool, auto_presmooth: bool) -> None:
    """Exit on flags a multi-process run cannot take, before any process
    joins the group (the JAX CLI's checks)."""
    if not args.coordinator:
        return
    if auto_disp:
        raise SystemExit("--max_displacement auto needs the input volume on "
                         "one host to probe; pass an explicit bound with "
                         "--coordinator runs")
    if auto_presmooth:
        raise SystemExit("--flow_presmooth auto needs the input volume on "
                         "one host to measure; pass an explicit sigma with "
                         "--coordinator runs")
    if args.host_id is None or not (0 <= args.host_id < args.num_hosts):
        raise SystemExit("--coordinator requires --num_hosts and a "
                         "--host_id in [0, num_hosts)")
    if args.stream or args.checkpoint_dir:
        raise SystemExit("--stream/--checkpoint_dir are not supported "
                         "with --coordinator (multi-process runs)")
    from flowdenoising_tpu_torch.io.volume import is_mrc_input, is_mrc_output
    if not (is_mrc_input(args.input) and is_mrc_output(args.output)):
        raise SystemExit("--coordinator runs need MRC input and output "
                         "(sharded file I/O); convert TIFF stacks first")


def _main_distributed(args, cfg, kernels, device, prof) -> int:
    """Multi-process file-to-file run (parallel/distributed.py): each rank
    reads its Z planes, the passes run sharded over the process group, and
    each rank writes its planes of the shared output file."""
    import torch.distributed as dist

    from flowdenoising_tpu_torch.io.mrc import read_mrc_header
    from flowdenoising_tpu_torch.parallel.distributed import (
        init_distributed, run_distributed)
    from flowdenoising_tpu_torch.utils.progress import ProgressReporter

    if not os.path.exists(args.input):
        raise SystemExit(f"input volume not found: {args.input}")
    shape = read_mrc_header(args.input).shape
    dev = init_distributed(args.coordinator, args.num_hosts, args.host_id,
                           device)
    try:
        logging.info(f"rank {args.host_id} of {args.num_hosts} on {dev}, "
                     f"backend {dist.get_backend()}")
        with prof.phase("filter"), ProgressReporter(sum(shape)) as progress:
            run_distributed(args.input, args.output, cfg, kernels,
                            on_pass=lambda i, _: progress.advance(shape[i]),
                            device=dev)
    finally:
        dist.destroy_process_group()
    prof.report()
    return 0


def _device(name: str) -> torch.device:
    """The requested device; never a silent substitute."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch "
                         "versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda or cpu")
    return dev


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.show_fingerprint:
        print("fingerprint =", file_fingerprint(__file__))

    verbosity = args.verbosity if isinstance(args.verbosity, int) else 0
    setup_logging(verbosity)
    if args.max_displacement is None:
        # no probe without flow; a multi-process run has no volume on one
        # host to probe
        args.max_displacement = (MAX_DISPLACEMENT
                                 if args.no_OF or args.coordinator else "auto")
    auto_disp = args.max_displacement == "auto"
    if isinstance(args.max_displacement, str) and not auto_disp:
        raise SystemExit(f"--max_displacement must be an integer or 'auto', "
                         f"got {args.max_displacement!r}")
    auto_presmooth = args.flow_presmooth == "auto"
    if isinstance(args.flow_presmooth, str) and not auto_presmooth:
        raise SystemExit(f"--flow_presmooth must be a number or 'auto', "
                         f"got {args.flow_presmooth!r}")
    if args.no_OF and (auto_disp or auto_presmooth):
        logging.info("--max_displacement/--flow_presmooth auto ignored: flow "
                     "compensation is disabled (-n)")
    _refuse_unported(args)
    _check_distributed(args, auto_disp, auto_presmooth)
    device = _device(args.device)
    if args.devices not in (None, 1) and device.index is not None:
        raise SystemExit(f"--devices {args.devices} shards over the first "
                         f"cards; pass --device cuda, not {args.device}")
    # full float32 for the resize matrix products (PyTorch's default; a
    # TF32 product keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    prof = PhaseProfiler()

    sigma = tuple(float(s) for s in args.sigma)
    if len(sigma) == 1:
        sigma = sigma * 3
    logging.info(f"sigma={sigma}")

    # with auto, the fixed default stands until the probe replaces it (its
    # floors fall back to it)
    md = MAX_DISPLACEMENT if auto_disp else int(args.max_displacement)
    cfg = FilterConfig(
        sigma=sigma,
        boundary=Boundary(args.boundary),
        use_flow=not args.no_OF,
        flow=FlowConfig(
            levels=int(args.levels),
            winsize=int(args.winsize),
            use_initial_flow=not args.recompute_flow,
            max_displacement=md if md > 0 else None,
            dtype=args.dtype,
            precision=args.precision,
            tap_mode=args.tap_flow,
            symmetric_adjacent=args.symmetric_adjacent,
            presmooth=0.0 if auto_presmooth else float(args.flow_presmooth),
        ),
        slab_size=args.slab_size,
    )
    if args.recompute_flow:
        logging.info("No reusing adjacent OF fields as predictions")
    else:
        logging.info("Using adjacent OF fields as predictions")
    if args.number_of_processes is not None or args.use_GPU or args.use_threads:
        logging.info("-p/--use_GPU/--use_threads accepted for reference "
                     f"compatibility; the work runs on {device}")
    if args.coordinator:
        kernels = get_gaussian_kernels(sigma)
        logging.info(f"length of each filter (Z, Y, X) = {[len(k) for k in kernels]}")
        return _main_distributed(args, cfg, kernels, device, prof)

    from flowdenoising_tpu_torch.core.pipeline import denoise, volume_mean
    from flowdenoising_tpu_torch.io.volume import (
        is_mrc_input, read_volume, write_volume)

    if isinstance(args.input, str) and not os.path.exists(args.input):
        raise SystemExit(f"input volume not found: {args.input}")
    out_dir = os.path.dirname(os.path.abspath(str(args.output)))
    if not os.path.isdir(out_dir):
        raise SystemExit(f"output directory does not exist: {out_dir}")

    voxel_size = None
    if is_mrc_input(args.input):
        from flowdenoising_tpu_torch.io.mrc import read_mrc_header
        try:
            voxel_size = read_mrc_header(args.input).voxel_size
        except (OSError, ValueError):
            voxel_size = None

    with prof.phase("read"):
        # --stream keeps the volume memory-mapped in its stored dtype; the
        # windows are converted as they are read
        if args.stream:
            vol = read_volume(args.input, memory_map=True)
        else:
            vol = read_volume(args.input, memory_map=args.memory_map,
                              as_f32=True)
    log_volume_stats(str(args.input), vol)

    if auto_disp and cfg.use_flow:
        from flowdenoising_tpu_torch.core.autodisp import (
            resolve_auto_displacement)
        with prof.phase("probe"):
            cfg = resolve_auto_displacement(vol, cfg, device=device)
    if auto_presmooth and cfg.use_flow:
        from flowdenoising_tpu_torch.core.noise import resolve_auto_presmooth
        cfg = resolve_auto_presmooth(vol, cfg)

    kernels = get_gaussian_kernels(sigma)
    logging.info(f"length of each filter (Z, Y, X) = {[len(k) for k in kernels]}")
    logging.info(f"PyTorch {torch.__version__} on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})"
                    if device.type == "cuda" else ""))

    shape = np.shape(vol)
    ckpt, start_pass, mean_val = None, 0, None
    if cfg.boundary is Boundary.MEAN and not args.stream:
        mean_val = volume_mean(vol)
    if args.checkpoint_dir and args.stream:
        logging.warning("--checkpoint_dir is ignored with --stream (a "
                        "streamed run keeps no checkpoint)")
        args.checkpoint_dir = None
    if args.checkpoint_dir:
        from flowdenoising_tpu_torch.utils.checkpoint import CheckpointManager
        ckpt = CheckpointManager(args.checkpoint_dir, cfg, vol, mean=mean_val)
        resumed = ckpt.load_latest()
        if resumed is not None:
            start_pass, vol, mean_val = resumed

    from flowdenoising_tpu_torch.utils.progress import ProgressReporter
    # one unit per output slice per pass, the completed passes done
    progress = ProgressReporter(total_units=int(sum(shape)))
    progress.advance(sum(shape[:start_pass]))

    # -v 2: profile the actual run for the measured per-stage report; the
    # profiler's stop and the trace export are a phase of their own, so the
    # filter phase times the same work as at -v 1
    trace_ctx = contextlib.nullcontext({})
    if verbosity >= 2:
        from flowdenoising_tpu_torch.utils.trace_report import traced_run
        trace_ctx = traced_run(lambda: prof.phase("trace_export"))

    # --stream: the scratch memmaps and the result live here until the
    # output is written, and go even when the run fails
    stream_dir = tempfile.mkdtemp(prefix="fdt_stream_") if args.stream else None
    try:
        with trace_ctx as trace_state:
            with prof.phase("filter"), progress:
                if args.stream:
                    from flowdenoising_tpu_torch.core.stream import (
                        denoise_streamed)
                    filtered = np.memmap(
                        os.path.join(stream_dir, "denoised.f32"),
                        dtype=np.float32, mode="w+", shape=shape)
                    state = {"done": 0}

                    def stream_progress(done, _total):
                        progress.advance(done - state["done"])
                        state["done"] = done

                    denoise_streamed(vol, cfg, kernels, tmp_dir=stream_dir,
                                     out=filtered, slab_size=args.slab_size,
                                     progress=stream_progress,
                                     n_devices=args.devices, device=device)
                else:
                    def on_pass(i, v):
                        progress.advance(shape[i])
                        if ckpt is not None:
                            ckpt.save_pass(i, v)

                    if args.devices not in (None, 1):
                        from flowdenoising_tpu_torch.parallel.mesh import (
                            denoise_sharded)
                        filtered = denoise_sharded(
                            vol, cfg, kernels=kernels, n_devices=args.devices,
                            start_pass=start_pass, mean_val=mean_val,
                            on_pass=on_pass, device=device)
                    else:
                        filtered = denoise(
                            vol, cfg, kernels=kernels, start_pass=start_pass,
                            mean_val=mean_val, on_pass=on_pass, device=device)
                    filtered = filtered.cpu().numpy()

        log_volume_stats(str(args.output), filtered)

        with prof.phase("write"):
            write_volume(args.output, filtered, quantize=args.tiff_quantize,
                         voxel_size=voxel_size)
        # only once the output is written: a run that fails before can
        # restart from the finished volume
        if ckpt is not None:
            ckpt.clear()
    finally:
        if stream_dir is not None:
            shutil.rmtree(stream_dir, ignore_errors=True)
    prof.report()

    if verbosity >= 2:
        # per-stage device time: measured from the run's trace, else (no
        # device event: a CPU run) the labelled reconstruction
        from flowdenoising_tpu_torch.utils.stage_report import (
            device_stage_report)
        from flowdenoising_tpu_torch.utils.trace_report import (
            measured_stage_report)
        path = trace_state.get("path")
        try:
            measured = measured_stage_report(path)
        finally:
            if path:
                os.remove(path)
        if measured is None:
            device_stage_report(shape, cfg, kernels, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

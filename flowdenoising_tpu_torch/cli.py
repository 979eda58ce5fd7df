"""Command-line interface, flag-compatible with the JAX package's CLI
(``flowdenoising_tpu/cli.py``) and the reference ``flowdenoising.py``.

Usage:
    python -m flowdenoising_tpu_torch -i vol.mrc -o denoised.mrc -s 2 2 2

The port runs the solve-mode flow denoise (and ``-n``) in float32 on one
device, in memory, with a fixed displacement bound (default 8; 0 means no
bound).  Every flag of a feature not yet ported exits with a message naming
its ROADMAP item; none is ignored.  ``--device`` picks the device: ``cuda``
(the default) runs the CUDA kernels and fails without a CUDA device;
``cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

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
                   help="Process each pass in slabs of this many output slices")
    p.add_argument("--devices", type=int, default=None,
                   help="Number of devices (not yet ported: one device only, ROADMAP A11)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="Optical-flow compute dtype (bfloat16 not yet ported, ROADMAP A9)")
    p.add_argument("--precision", choices=["float32", "bfloat16"], default="float32",
                   help="Flow inner-pass precision (bfloat16 not yet ported, ROADMAP A9)")
    p.add_argument("--tap_flow", choices=["solve", "compose"], default="solve",
                   help="Per-tap flow strategy: 'solve' = one Farneback solve per "
                        "tap pair ('compose' not yet ported, ROADMAP A9)")
    p.add_argument("--max_displacement", type=int_or_str, default=MAX_DISPLACEMENT,
                   help="Per-tap flow sampling bound in pixels; motions beyond it "
                        "are clamped during sampling.  0 = no bound (exact "
                        "sampling).  'auto' is not yet ported (ROADMAP A8)")
    p.add_argument("--flow_presmooth", type=float_or_str, default=0.0,
                   help="Estimate flows from an in-plane pre-smoothed copy "
                        "(not yet ported, ROADMAP A8); 0 = off")
    p.add_argument("--symmetric_adjacent", action="store_true",
                   help="Compose mode option (not yet ported, ROADMAP A9)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Per-pass checkpoints (not yet ported, ROADMAP A10)")
    p.add_argument("--stream", action="store_true",
                   help="Disk-streamed passes (not yet ported, ROADMAP A10)")
    p.add_argument("--tiff_quantize", action="store_true",
                   help="Quantize TIFF output like the reference sequential "
                        "variant: uint8 if max < 256 else uint16")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process runs (not yet ported, ROADMAP A11)")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Multi-process runs (not yet ported, ROADMAP A11)")
    p.add_argument("--host_id", type=int, default=None,
                   help="Multi-process runs (not yet ported, ROADMAP A11)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions")
    return p


def _refuse_unported(args) -> None:
    """Exit, naming the ROADMAP item, on any flag of an unported feature."""
    md = args.max_displacement
    if md == "auto":
        raise SystemExit("--max_displacement auto is not yet ported "
                         "(ROADMAP A8); pass an integer bound (default 8) "
                         "or 0 for no bound")
    if isinstance(md, str):
        raise SystemExit(f"--max_displacement must be an integer, got {md!r}")
    if args.flow_presmooth != 0.0:
        raise SystemExit("--flow_presmooth is not yet ported (ROADMAP A8)")
    if args.tap_flow != "solve" or args.symmetric_adjacent:
        raise SystemExit("--tap_flow compose and --symmetric_adjacent are "
                         "not yet ported (ROADMAP A9)")
    if args.dtype != "float32" or args.precision != "float32":
        raise SystemExit("--dtype/--precision bfloat16 is not yet ported "
                         "(ROADMAP A9)")
    if args.stream or args.checkpoint_dir:
        raise SystemExit("--stream and --checkpoint_dir are not yet ported "
                         "(ROADMAP A10)")
    if (args.devices not in (None, 1) or args.coordinator
            or args.num_hosts != 1 or args.host_id is not None):
        raise SystemExit("--devices, --coordinator, --num_hosts and "
                         "--host_id are not yet ported (ROADMAP A11)")


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
    _refuse_unported(args)
    device = _device(args.device)
    # full float32 for the resize matrix products (PyTorch's default; a
    # TF32 product keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    if verbosity >= 2:
        logging.info("the per-stage trace report of -v 2 is not yet ported "
                     "(ROADMAP A12); logging at debug level only")
    prof = PhaseProfiler()

    sigma = tuple(float(s) for s in args.sigma)
    if len(sigma) == 1:
        sigma = sigma * 3
    logging.info(f"sigma={sigma}")

    md = int(args.max_displacement)
    cfg = FilterConfig(
        sigma=sigma,
        boundary=Boundary(args.boundary),
        use_flow=not args.no_OF,
        flow=FlowConfig(
            levels=int(args.levels),
            winsize=int(args.winsize),
            use_initial_flow=not args.recompute_flow,
            max_displacement=md if md > 0 else None,
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

    from flowdenoising_tpu_torch.core.pipeline import denoise
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
        vol = read_volume(args.input, memory_map=args.memory_map, as_f32=True)
    log_volume_stats(str(args.input), vol)

    kernels = get_gaussian_kernels(sigma)
    logging.info(f"length of each filter (Z, Y, X) = {[len(k) for k in kernels]}")
    logging.info(f"PyTorch {torch.__version__} on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})"
                    if device.type == "cuda" else ""))

    from flowdenoising_tpu_torch.utils.progress import ProgressReporter
    shape = np.shape(vol)
    progress = ProgressReporter(total_units=int(sum(shape)))

    with prof.phase("filter"), progress:
        def on_pass(i, _v):
            progress.advance(shape[i])

        vol_t = torch.from_numpy(np.ascontiguousarray(vol)).to(device)
        filtered = denoise(vol_t, cfg, kernels=kernels, on_pass=on_pass)
        filtered = filtered.cpu().numpy()
        del vol_t

    log_volume_stats(str(args.output), filtered)

    with prof.phase("write"):
        write_volume(args.output, filtered, quantize=args.tiff_quantize,
                     voxel_size=voxel_size)
    prof.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())

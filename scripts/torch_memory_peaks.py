"""Peak device memory of the PyTorch/CUDA port's axis passes on one GPU:
the data that ``flowdenoising_tpu_torch/core/memory.py``'s slab model is
fitted to.

    python3 scripts/torch_memory_peaks.py [--json peaks.jsonl] [--forms F ...]

For each pass form (the no-flow Gaussian; solve at D 8, 48 and no bound;
solve presmoothed; compose, symmetric compose; the bf16 forms, with a
bound and without one) and each
padded window (n + 2*ks2, h, w) at sigma 2 (ks2 8), one pass over the
window already on the card: the peak of ``torch.cuda.max_memory_allocated``
above what was allocated before the window was made, so the window itself
counts, and that peak in bytes per padded voxel (n + 2*ks2) * h * w.
``max_memory_reserved`` beside it says what the caching allocator held.
Then whether a pass over slabs of the window equals the whole pass bit for
bit (``scripts/torch_resize_batch_check.py`` looks at larger planes).
One JSON line per measurement.  ``--forms`` measures only the named
forms and skips the slab comparison.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORMS = {
    "gaussian": None,
    "solve": {},
    "solve_d48": {"max_displacement": 48},
    "solve_unbounded": {"max_displacement": None},
    "presmooth": {"presmooth": 1.5},
    "compose": {"tap_mode": "compose"},
    "compose_symmetric": {"tap_mode": "compose", "symmetric_adjacent": True},
    "solve_bf16": {"dtype": "bfloat16", "precision": "bfloat16"},
    "solve_precision_bf16": {"precision": "bfloat16"},
    "solve_dtype_bf16": {"dtype": "bfloat16"},
    "compose_bf16": {"tap_mode": "compose", "dtype": "bfloat16",
                     "precision": "bfloat16"},
    "fast": {"tap_mode": "compose", "symmetric_adjacent": True,
             "dtype": "bfloat16", "precision": "bfloat16"},
    "solve_bf16_nobound": {"dtype": "bfloat16", "max_displacement": None},
    "fast_nobound": {"tap_mode": "compose", "symmetric_adjacent": True,
                     "dtype": "bfloat16", "precision": "bfloat16",
                     "max_displacement": None},
}
# output planes n and plane (h, w) of the measured windows
WINDOWS = [(64, 256, 256), (256, 256, 256), (32, 512, 512), (128, 512, 512),
           (16, 1024, 1024), (64, 1024, 1024), (64, 128, 1024), (64, 1024, 128)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the lines here")
    ap.add_argument("--forms", nargs="+", choices=sorted(FORMS), default=None,
                    help="measure only these pass forms")
    args = ap.parse_args()
    forms = {k: FORMS[k] for k in args.forms} if args.forms else FORMS
    import numpy as np
    import torch

    from flowdenoising_tpu_torch.config import FlowConfig
    from flowdenoising_tpu_torch.core.axis_filter import (
        gaussian_pass_padded, of_pass_padded)
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    taps = get_gaussian_kernels((2.0, 2.0, 2.0))[0]
    ks2 = len(taps) // 2
    sink = open(args.json, "w") if args.json else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    def run(fields, window):
        if fields is None:
            return gaussian_pass_padded(window, taps)
        return of_pass_padded(window, taps, FlowConfig(**fields))

    r = np.random.default_rng(0)
    for n, h, w in WINDOWS:
        host = (r.normal(size=(n + 2 * ks2, h, w)) * 40 + 100).astype(np.float32)
        for name, fields in forms.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            window = torch.from_numpy(host).to(dev)
            out = run(fields, window)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            reserved = torch.cuda.max_memory_reserved()
            del window, out
            voxels = (n + 2 * ks2) * h * w
            emit({"form": name, "n": n, "h": h, "w": w, "ks2": ks2,
                  "peak_bytes": peak, "bytes_per_padded_voxel": peak / voxels,
                  "max_reserved_bytes": reserved})
    # slabs against the whole pass, on one window of 256 output planes
    host = (r.normal(size=(256 + 2 * ks2, 256, 256)) * 40 + 100).astype(np.float32)
    window = torch.from_numpy(host).to(dev)
    for name in () if args.forms else ("gaussian", "solve", "compose"):
        whole = run(FORMS[name], window)
        for slab in (76, 64):
            parts = [run(FORMS[name], window[s:s + slab + 2 * ks2])
                     for s in range(0, 256 - slab + 1, slab)]
            got = torch.cat(parts)
            ref = whole[:got.shape[0]]
            emit({"slabs_vs_whole": name, "slab": slab,
                  "bit_identical": bool(torch.equal(got, ref)),
                  "max_abs_diff": float((got - ref).abs().max())})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Whether the port's resize products give a plane the same bits whatever
batch it is resized in, on one GPU.

    python3 scripts/torch_resize_batch_check.py [--json FILE]

A resize that folds the batch of planes into one dimension of a matrix
product lets the library pick another algorithm, with another order of
the sums, for another batch; ``ops/resize.py`` takes one product per
plane (``torch.bmm``) for that reason.  For the
plane shapes of the 256^3, 512^3 and 512x1024x1024 passes, each pyramid
level's linear resize of a stack of B planes (B as a whole pass's padded
stack) is compared with the same resize of its first s planes (s as a
window's), and the seed flow's area resize and the flows' upsampling
likewise; each in two forms: ``einsum`` (the batch folded into a matrix
dimension, the port's form before) and ``bmm`` (``_apply_separable``: a
batched product with the plane's shapes).  Also whether the two forms
agree, and their times at the 256^3 shapes.  Then the expansion pyramid
of a window against the whole stack's, level by level, and a whole solve
pass of the 512x1024x1024 volume's Y axis against windows of 153 planes
in each form.  One JSON line per comparison.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    from flowdenoising_tpu_torch.config import FlowConfig
    from flowdenoising_tpu_torch.ops import resize as R
    from flowdenoising_tpu_torch.ops.farneback import polyexp_pyramid

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sink = open(args.json, "w") if args.json else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    def einsum_form(img, wr, wc):
        """The form before: the batch folded into a matrix dimension."""
        dtype = img.dtype
        wr_t = torch.as_tensor(wr, dtype=dtype, device=img.device).float()
        wc_t = torch.as_tensor(wc, dtype=dtype, device=img.device).float()
        with R._full_float32():
            out = torch.einsum("hH,...HW->...hW", wr_t, img.float()).to(dtype)
            return torch.einsum("wW,...hW->...hw", wc_t, out.float()).to(dtype)

    forms = {"einsum": einsum_form, "bmm": R._apply_separable}
    r = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    # (padded stack B, window planes s, plane h x w)
    cases = [(272, (92, 64), (256, 256)), (528, (169, 92), (512, 512)),
             (1040, (169, 92), (512, 1024)), (528, (169, 92), (1024, 1024))]
    for b, subs, (h, w) in cases:
        sizes = R.pyramid_sizes(h, w, 3, 0.5)
        x = t(r.normal(size=(b, h, w)) * 40 + 100)
        for k in range(1, len(sizes)):
            out_hw = sizes[k]
            wr = R.linear_resize_matrix(h, out_hw[0])
            wc = R.linear_resize_matrix(w, out_hw[1])
            whole = {name: f(x, wr, wc) for name, f in forms.items()}
            for s in subs:
                for name, f in forms.items():
                    part = f(x[:s], wr, wc)
                    emit({"op": "linear", "plane": [h, w], "out": list(out_hw),
                          "batch": b, "sub": s, "form": name,
                          "bit_identical": bool(torch.equal(part, whole[name][:s])),
                          "max_abs_diff": float((part - whole[name][:s]).abs().max())})
            emit({"op": "linear", "plane": [h, w], "out": list(out_hw), "batch": b,
                  "forms_equal": bool(torch.equal(whole["einsum"], whole["bmm"])),
                  "max_abs_diff": float((whole["einsum"] - whole["bmm"]).abs().max())})
            del whole
        # the seed flow's area resize to the coarsest level, (n, 2, h, w)
        n = b - 16
        f = t(r.normal(size=(n, 2, h, w)) * 2)
        wr = R.area_resize_matrix(h, sizes[-1][0])
        wc = R.area_resize_matrix(w, sizes[-1][1])
        whole = {name: fn(f, wr, wc) for name, fn in forms.items()}
        for s in subs:
            for name, fn in forms.items():
                part = fn(f[:s - 16], wr, wc)
                emit({"op": "area", "plane": [h, w], "out": list(sizes[-1]),
                      "batch": n, "sub": s - 16, "form": name,
                      "bit_identical": bool(torch.equal(part, whole[name][:s - 16])),
                      "max_abs_diff": float((part - whole[name][:s - 16]).abs().max())})
        emit({"op": "area", "plane": [h, w], "batch": n,
              "forms_equal": bool(torch.equal(whole["einsum"], whole["bmm"]))})
        del whole, f
        # the flows' linear upsampling between levels, (n, 2, h_k+1, w_k+1)
        for k in range(len(sizes) - 1):
            f = t(r.normal(size=(n, 2) + sizes[k + 1]) * 2)
            wr = R.linear_resize_matrix(sizes[k + 1][0], sizes[k][0])
            wc = R.linear_resize_matrix(sizes[k + 1][1], sizes[k][1])
            whole = {name: fn(f, wr, wc) for name, fn in forms.items()}
            for s in subs:
                for name, fn in forms.items():
                    part = fn(f[:s - 16], wr, wc)
                    emit({"op": "flow_up", "plane": [h, w], "out": list(sizes[k]),
                          "batch": n, "sub": s - 16, "form": name,
                          "bit_identical": bool(torch.equal(part, whole[name][:s - 16])),
                          "max_abs_diff": float((part - whole[name][:s - 16]).abs().max())})
            emit({"op": "flow_up", "plane": [h, w], "out": list(sizes[k]), "batch": n,
                  "forms_equal": bool(torch.equal(whole["einsum"], whole["bmm"]))})
            del whole, f
        # the expansion pyramid of a window against the whole stack's
        cfg = FlowConfig()
        full = polyexp_pyramid(x, cfg)
        for s in subs:
            win = polyexp_pyramid(x[:s].clone(), cfg)
            emit({"op": "pyramid", "plane": [h, w], "batch": b, "sub": s,
                  "levels_bit_identical": [bool(torch.equal(a[:s], c))
                                           for a, c in zip(full, win)]})
        del full, x
        torch.cuda.empty_cache()
    # a whole solve pass of the 512x1024x1024 Y axis (1024 planes of
    # 512 x 1024, padded) against two windows of 153 planes, in each form
    import chip_smoke
    from flowdenoising_tpu_torch.core.axis_filter import of_pass_padded
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    taps = get_gaussian_kernels((2.0, 2.0, 2.0))[1]
    host = chip_smoke.blob_volume(1040, 512, 1024, 0)
    host += r.normal(0.0, 40.0, host.shape).astype(np.float32)
    padded = torch.from_numpy(host).to(dev)
    del host
    saved = R._apply_separable
    for name, fn in forms.items():
        R._apply_separable = fn
        try:
            whole = of_pass_padded(padded, taps, FlowConfig())
            for a in (0, 153, 871):
                part = of_pass_padded(padded[a:a + 169], taps, FlowConfig())
                emit({"op": "pass", "form": name, "plane": [512, 1024],
                      "window_start": a,
                      "bit_identical": bool(torch.equal(part, whole[a:a + 153])),
                      "max_abs_diff": float((part - whole[a:a + 153]).abs().max())})
                del part
            del whole
            torch.cuda.empty_cache()
        finally:
            R._apply_separable = saved
    del padded
    torch.cuda.empty_cache()
    # times at the 256^3 pass's largest resize, in turns
    x = t(r.normal(size=(272, 256, 256)))
    wr, wc = R.linear_resize_matrix(256, 128), R.linear_resize_matrix(256, 128)
    times = {name: [] for name in forms}
    for name in ("einsum", "bmm", "bmm", "einsum"):
        f = forms[name]
        for _ in range(3):
            f(x, wr, wc)
        torch.cuda.synchronize()
        a, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            f(x, wr, wc)
        b_.record()
        torch.cuda.synchronize()
        times[name].append(a.elapsed_time(b_) / 20)
    emit({"op": "time_ms", "shape": [272, 256, 256], "out": [128, 128], **times})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

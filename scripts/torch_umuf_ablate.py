"""Where K-umuf's time goes at the main call: ablations on the card.

    python3 scripts/torch_umuf_ablate.py

Builds patched copies of ``flowdenoising_tpu_torch/csrc/umuf.cu`` (and the
``farneback.cuh`` it includes) under ``build/umuf_ablate/``, one library a
variant, with the port's own nvcc flags: ``base`` (the sources as they
are), ``no_r1`` (phase 1's r1 taps replaced by values of their indices),
``no_r0`` (r0's loads by values of the pixel index), ``no_ramp`` (the
border ramp by 1), ``no_phase1`` (M from the flow alone) and ``no_phase2``
(the box sum and solve replaced by one copy).  Each variant's outputs are
wrong by design; only their times mean something.  Times both entries --
the packed form ``fdt_umuf_bf16`` at its planned 32x64 tile and at a 32x32
tile, and the float32 form -- at (256, 5, 256, 256), d 9, winsize 5, 3
iterations, two turns each (CUDA events, 5 launches a turn), and prints one
line a variant and entry and the card's nvidia-smi line.

    python3 scripts/torch_umuf_ablate.py --vs DIR

builds this checkout's sources and those of another ``csrc`` directory DIR
(for example the parent commit's, unpacked with ``git archive``) instead,
and times the entries both have at the main call and at the 128^2 (d 5)
and 64^2 (d 3) levels of the 256^3 path, in turns: DIR's, this checkout's,
this checkout's, DIR's, 10 launches a turn.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "flowdenoising_tpu_torch" / "csrc"
OUT = REPO / "build" / "umuf_ablate"

M = "m[0] = dx; m[1] = dy; m[2] = dx * dy; m[3] = dx + 1.0f; m[4] = dy + 1.0f;"
VARIANTS = {
    "base": [],
    "no_r1": [("farneback.cuh", f"const float v{n} = load_f32(q + {o});",
               f"const float v{n} = (float)({o} + c);")
              for n, o in (("00", "ra + xa"), ("01", "ra + xb"), ("10", "rb + xa"),
                           ("11", "rb + xb"))],
    "no_r0": [("farneback.cuh",
               "const float a0 = R0[p], a1 = R0[hw + p], a2 = R0[2 * hw + p];",
               "const float a0 = (float)p, a1 = a0 * 0.5f, a2 = a0 * 0.25f;"),
              ("farneback.cuh",
               "const float a3 = R0[3 * hw + p], a4 = R0[4 * hw + p];",
               "const float a3 = a0 * 0.125f, a4 = a0 * 2.0f;")],
    "no_ramp": [("farneback.cuh",
                 "float sc = (float)(edge_weight(y, H) * edge_weight(x, W));",
                 "float sc = 1.0f;")],
    "no_phase1": [("umuf.cu", "matrices_from(R0, R1, dx, dy, x, y, H, W, hw, d, clamp, "
                   "ramp_bf16, m);", M)],
    "no_phase2": [("umuf.cu",
                   "      box_solve(m_s, mplane, sw, r, g, inv_ws2, Uo + p, Vo + p, W);",
                   "      Uo[p] = m_s[0]; Vo[p] = m_s[1];"),
                  ("umuf.cu",
                   "      box_solve(m_s, mplane, sw, r, g, inv_ws2, fu + q, fv + q, sw);",
                   "      if (threadIdx.x < 64) fu[q + threadIdx.x] = m_s[threadIdx.x];")],
}
ENTRIES = ("fdt_umuf", "fdt_umuf_bf16")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vs", type=Path, default=None,
                    help="another csrc directory to time this checkout's against")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from flowdenoising_tpu_torch.ops import farneback as F
    from flowdenoising_tpu_torch.ops.cuda import bind
    from flowdenoising_tpu_torch.ops.cuda.build import (
        ARCH_FLAGS, COMPILE_FLAGS, nvcc_path)
    from flowdenoising_tpu_torch.ops.cuda.umuf import plan_umuf

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sources = ({"other": args.vs.resolve(), "this": SRC} if args.vs else
               dict.fromkeys(VARIANTS, SRC))
    procs = {}
    for name, src in sources.items():
        patches = [] if args.vs else VARIANTS[name]
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for f, old, new in patches:
            text = (d / f).read_text()
            if old not in text:
                print(f"{name}: the line to patch is gone: {old}", file=sys.stderr)
                return 1
            (d / f).write_text(text.replace(old, new))
        obj, so = d / "umuf.o", d / "libumuf.so"
        cmd = ([nvcc_path(), *COMPILE_FLAGS, "-o", str(obj), str(d / "umuf.cu")],
               [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(so), str(obj)])
        procs[name] = (subprocess.Popen(cmd[0], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), cmd[1], so)
    libs = {}
    for name, (proc, link, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode or subprocess.run(link).returncode:
            print(f"{name}: build failed\n{out[-2000:]}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        for e in ENTRIES:
            if hasattr(lib, e):
                bind(lib, e)
        libs[name] = lib
    if args.vs:
        return compare(libs, torch, F, plan_umuf)

    dev = torch.device("cuda", 0)
    r = np.random.default_rng(0)
    rr = F.poly_expand(torch.from_numpy(
        (r.normal(size=(2, 256, 256, 256)) * 40).astype(np.float32)).to(dev)).contiguous()
    r0, r1, r1b = rr[0], rr[1], rr[1].to(torch.bfloat16)
    flow = torch.from_numpy((r.normal(size=(256, 2, 256, 256)) * 1.5)
                            .astype(np.float32)).to(dev)
    out = torch.empty_like(flow)
    stream = torch.cuda.current_stream().cuda_stream
    plan = plan_umuf(256, 256, 5, 3)
    at_32x32 = dataclasses.replace(plan, tile_y=32, tile_x=32, threads=256)
    cases = {"bf16": ("fdt_umuf_bf16", r1b, plan),
             "float32": ("fdt_umuf", r1, plan),
             "bf16_at_32x32": ("fdt_umuf_bf16", r1b, at_32x32)}

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for case, (entry, src, plan) in cases.items():
                fn = getattr(lib, entry)

                def call(fn=fn, src=src, plan=plan):
                    rc = fn(r0.data_ptr(), src.data_ptr(), flow.data_ptr(),
                            out.data_ptr(), 256, 256, 256, 9.0, 1, 0, 5,
                            float(np.float32(1 / 25)), 3, plan.tile_y,
                            plan.tile_x, plan.threads, stream)
                    if rc:
                        raise RuntimeError(f"{name} {entry}: CUDA error {rc}")

                times.setdefault((name, case), []).append(ms(call))
    for (name, case), v in times.items():
        print(f"{name:10s} {case:16s} " + ", ".join(f"{x:.4f}" for x in v) + " ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


def compare(libs, torch, F, plan_umuf) -> int:
    """--vs: the entries both libraries have, in turns (other, this, this,
    other) at the 256^3 path's level calls."""
    dev = torch.device("cuda", 0)
    r = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    entries = [e for e in ENTRIES if all(hasattr(lib, e) for lib in libs.values())]
    for size, d in ((256, 9), (128, 5), (64, 3)):
        rr = F.poly_expand(torch.from_numpy(
            (r.normal(size=(2, 256, size, size)) * 40).astype(np.float32)).to(dev)
        ).contiguous()
        srcs = {"fdt_umuf": rr[1], "fdt_umuf_bf16": rr[1].to(torch.bfloat16)}
        flow = torch.from_numpy((r.normal(size=(256, 2, size, size)) * 1.5 * d / 9)
                                .astype(np.float32)).to(dev)
        outs = {}
        for entry in entries:
            plan = plan_umuf(size, size, 5, 3)
            times = {name: [] for name in libs}
            for name in ("other", "this", "this", "other"):
                out = torch.empty_like(flow)
                fn = getattr(libs[name], entry)

                def call(fn=fn, out=out, plan=plan, entry=entry):
                    rc = fn(rr[0].data_ptr(), srcs[entry].data_ptr(), flow.data_ptr(),
                            out.data_ptr(), 256, size, size, float(d), 1, 0, 5,
                            float(np.float32(1 / 25)), 3, plan.tile_y,
                            plan.tile_x, plan.threads, stream)
                    if rc:
                        raise RuntimeError(f"{name} {entry}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                outs.setdefault(entry, out)
                if not torch.equal(out, outs[entry]):
                    print(f"{entry} ({size}^2): the two builds differ", file=sys.stderr)
                    return 1
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(10):
                    call()
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b) / 10)
            print(f"(256,5,{size},{size}) d {d} {entry}: bit-identical; in turns, ms: "
                  + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                              for k, vs in times.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

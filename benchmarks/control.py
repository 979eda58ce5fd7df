#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 benchmarks/control.py --workload epfl.solve --seeds 1 2 3 --control 3

For each seed, in one process on the CUDA card: the pool volume that a run
of that seed samples, denoised by the program and by the plain reference,
and the compared numbers of ``benchmarks/compare.py`` between them (the
lower readings); for the first ``--control`` seeds also the
lower-precision control -- the reference with TF32 matrix products --
against the reference (the upper readings).  Both sides of the reference
run at the bounds the plain probe picks for an ``auto`` cell, and the line
names the program's pick beside it.  One JSON line a seed, then a summary
line: the largest program reading and the smallest control reading of each
number.  Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from benchmarks import compare, spec, volumes
    from benchmarks.run import Program, plain_flow, reference

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load(args.workload)
    program = Program(cell, device)
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        index = volumes.sampled(cell.traffic, seed)
        vol = volumes.volume(cell.config, seed, index, device).cpu().numpy()
        t = time.perf_counter()
        out = program(vol)
        t_program = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        flow = plain_flow(cell, vol, device)
        ref = reference(cell, vol, device, flow=flow)
        t_ref = time.perf_counter() - t
        line = {"seed": seed, "index": index, "program_s": t_program,
                "reference_s": t_ref,
                "program": compare.readings(out, ref)}
        if program.picks:
            line["picks"] = {"program": program.picks[-1],
                             "plain": (flow["max_displacement"],
                                       flow["adjacent_displacement"])}
        del out
        if i < args.control:
            ctl = reference(cell, vol, device, tf32=True,
                            flow=flow).cpu().numpy()
            line["control"] = compare.readings(ctl, ref)
            del ctl
        del ref
        torch.cuda.empty_cache()
        for key, into in (("program", lower), ("control", upper)):
            for k, v in line.get(key, {}).items():
                into.setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

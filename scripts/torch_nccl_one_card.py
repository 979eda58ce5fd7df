"""Two NCCL ranks of the PyTorch/CUDA port's distributed CLI on one GPU.

    python3 scripts/torch_nccl_one_card.py [--timeout 180]

Writes a small seeded MRC volume and starts two CLI processes,
``--coordinator 127.0.0.1:PORT --num_hosts 2 --host_id 0|1 --device cuda``,
on a host with one card, so both ranks drive ``cuda:0``.  NCCL's
documentation says it refuses two ranks on one device; this shows what the
port's multi-process path does then: each rank's exit code and the last
lines it printed.  Every process is killed at the timeout.  Prints one
JSON line: the card, both exit codes, and whether a rank named NCCL's
duplicate-GPU refusal.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=180.0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from flowdenoising_tpu_torch.io.mrc import write_mrc

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "in.mrc"
        write_mrc(src, np.random.default_rng(0).normal(
            100.0, 20.0, (32, 64, 64)).astype(np.float32))
        env = dict(os.environ, PYTHONPATH=str(REPO))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "flowdenoising_tpu_torch", "-i", str(src),
             "-o", str(Path(tmp) / "out.mrc"), "-n", "--device", "cuda",
             "--coordinator", f"127.0.0.1:{port}", "--num_hosts", "2",
             "--host_id", str(i)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        outs = []
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=args.timeout)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0] + "\n[killed at the timeout]")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for i, out in enumerate(outs):
        print(f"--- rank {i}, exit {procs[i].returncode}:")
        print("\n".join(out.strip().splitlines()[-12:]))
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "exit_codes": [p.returncode for p in procs],
                      "duplicate_gpu_named": any("Duplicate GPU" in o for o in outs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

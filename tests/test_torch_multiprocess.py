"""The port's multi-process CLI over torch.distributed's gloo backend on
the CPU: two CLI processes (``--device cpu --coordinator 127.0.0.1:PORT
--num_hosts 2 --host_id I``) on one shared MRC write the file the
single-process CLI writes, bit for bit (Z 16 and the uneven Z 14, the
Gaussian and a flow case, the MEAN boundary); the MEAN fill across two
ranks equals ``volume_mean`` bit for bit; a world of one process runs
in-process with no message; and the flags a multi-process run cannot take
are refused before any process joins.  Each worker pins its thread count
to one; each spawn has a timeout, and the workers are killed when a test
fails, so a hung rank fails the test and does not hang the suite."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.core.pipeline import volume_mean
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120
_CLI = ("import sys, torch; torch.set_num_threads(1); "
        "from flowdenoising_tpu_torch.cli import main; sys.exit(main(sys.argv[1:]))")
_MEAN = """
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from flowdenoising_tpu_torch.io.volume import read_volume
from flowdenoising_tpu_torch.parallel.distributed import (
    GroupShards, init_distributed, sharded_mean)
from flowdenoising_tpu_torch.parallel.ingest import local_z_range
path, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
init_distributed(coord, 2, rank, "cpu")
try:
    src = read_volume(path, memory_map=True)
    bounds = [local_z_range(src.shape[0], 2, t) for t in range(2)]
    print("MEAN", sharded_mean(src, GroupShards("cpu"), bounds).tobytes().hex())
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs) -> list:
    """Run one process per argv (python -c ...) to the end; their outputs.
    Kills every process on a timeout or a failure."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    return outs


def _args(src, flags):
    return ["-i", str(src), "-s", "0.5", "0.5", "0.5", "--device", "cpu",
            "--max_displacement", "4", *flags]


@pytest.mark.parametrize("z", [16, 14])
@pytest.mark.parametrize("flags", [["-n"], ["-l", "0", "-w", "5"],
                                   ["-n", "--boundary", "mean"]],
                         ids=["gaussian", "of", "mean"])
def test_two_processes_write_the_single_process_file(tmp_path, z, flags):
    # z 14: uneven, each rank reads the whole file; passes boundary-extended
    vol = make_blob_volume(z, 24, 16, seed=23)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    args = _args(src, flags)
    assert cli.main([*args, "-o", str(tmp_path / "one.mrc")]) == 0
    coord = f"127.0.0.1:{_free_port()}"
    _spawn([[_CLI, *args, "-o", str(tmp_path / "two.mrc"), "--coordinator",
             coord, "--num_hosts", "2", "--host_id", str(i)] for i in range(2)])
    want, want_hdr = read_mrc(tmp_path / "one.mrc")
    got, hdr = read_mrc(tmp_path / "two.mrc")
    np.testing.assert_array_equal(got, want)
    for field in ("dmin", "dmax", "dmean", "rms"):
        a, b = getattr(hdr, field), getattr(want_hdr, field)
        assert abs(a - b) <= 1e-5 * abs(b), (field, a, b)


def test_mean_across_two_ranks_is_volume_mean(tmp_path):
    vol = (make_blob_volume(14, 24, 16, seed=24) * 37).astype(np.int16)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    coord = f"127.0.0.1:{_free_port()}"
    outs = _spawn([[_MEAN, str(src), coord, str(i)] for i in range(2)])
    want = volume_mean(vol).tobytes().hex()
    for out in outs:
        assert f"MEAN {want}" in out, out[-2000:]


def test_world_of_one_process(tmp_path):
    vol = make_blob_volume(12, 24, 16, seed=25)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    args = _args(src, ["-l", "0", "-w", "5", "--boundary", "replicate"])
    assert cli.main([*args, "-o", str(tmp_path / "one.mrc")]) == 0
    assert cli.main([*args, "-o", str(tmp_path / "group.mrc"), "--coordinator",
                     f"127.0.0.1:{_free_port()}", "--num_hosts", "1",
                     "--host_id", "0"]) == 0
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(read_mrc(tmp_path / "group.mrc")[0],
                                  read_mrc(tmp_path / "one.mrc")[0])


@pytest.mark.parametrize("flags,message", [
    (["--max_displacement", "auto"], "--max_displacement auto"),
    (["--max_displacement", "4", "--flow_presmooth", "auto"], "--flow_presmooth auto"),
    (["--max_displacement", "4", "--stream"], "--stream/--checkpoint_dir"),
    (["--max_displacement", "4", "--checkpoint_dir", "ck"], "--stream/--checkpoint_dir"),
    (["--max_displacement", "4", "--host_id", "2"], "--host_id in"),
    (["--max_displacement", "4", "--host_id", "-1"], "--host_id in"),
    (["--max_displacement", "4", "-o", "out.tif"], "MRC input and output"),
], ids=["auto", "presmooth_auto", "stream", "checkpoint", "host_id_high",
        "host_id_negative", "tiff"])
def test_refusals_before_joining(tmp_path, flags, message):
    src = tmp_path / "in.mrc"
    write_mrc(src, np.zeros((4, 8, 8), np.float32))
    flags = [f if f != "ck" else str(tmp_path / "ck") for f in flags]
    if "--host_id" not in flags:
        flags += ["--host_id", "0"]
    if "-o" not in flags:
        flags += ["-o", str(tmp_path / "out.mrc")]
    else:
        flags[flags.index("-o") + 1] = str(tmp_path / "out.tif")
    # no process listens at the coordinator: a run that tried to join would
    # fail (or wait) instead of exiting with the message
    with pytest.raises(SystemExit, match=message):
        cli.main(["-i", str(src), "--device", "cpu", "--coordinator",
                  f"127.0.0.1:{_free_port()}", "--num_hosts", "2", *flags])
    assert not torch.distributed.is_initialized()


def test_missing_host_id_is_refused(tmp_path):
    src = tmp_path / "in.mrc"
    write_mrc(src, np.zeros((4, 8, 8), np.float32))
    with pytest.raises(SystemExit, match="--host_id in"):
        cli.main(["-i", str(src), "-o", str(tmp_path / "o.mrc"), "--device",
                  "cpu", "--coordinator", "127.0.0.1:1", "--num_hosts", "2"])

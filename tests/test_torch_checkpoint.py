"""The port's pass-boundary checkpoints (``utils/checkpoint.py``) and the
pipeline's ``start_pass``/``mean_val``, on the CPU: the digest equal to the
JAX package's, a resume at pass 1, 2 or 3 equal to the uninterrupted run
at atol 0 (the JAX package's own tests allow 1e-3: its resume pads MEAN
with a float64 mean, its in-memory pass with a float32 one; the port uses
one ``volume_mean`` everywhere), the manifest's mean bit for bit, the
rejection of another configuration or input, and the CLI's resume after an
interruption.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu.utils.checkpoint import volume_digest as j_volume_digest

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core import pipeline
from flowdenoising_tpu_torch.core.pipeline import denoise, volume_mean
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.utils import checkpoint
from flowdenoising_tpu_torch.utils.checkpoint import (
    MANIFEST, CheckpointManager, volume_digest)

torch.set_num_threads(1)


def _cfg(boundary=Boundary.MEAN):
    return FilterConfig(sigma=(0.5, 1.0, 0.5), boundary=boundary,
                        flow=FlowConfig(levels=1, winsize=5, max_displacement=4))


@pytest.mark.parametrize("vol", [
    make_blob_volume(4, 16, 16, seed=24),
    make_blob_volume(40, 64, 64, seed=2),          # strided sample
    (make_blob_volume(6, 10, 12, seed=3) * 10).astype(np.int16),
])
def test_volume_digest_equals_jax(vol):
    assert volume_digest(vol) == j_volume_digest(vol)
    w = vol.copy()
    w.flat[0] += 1
    assert volume_digest(w) != volume_digest(vol)


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN])
@pytest.mark.parametrize("start_pass", [1, 2, 3])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, boundary,
                                     start_pass):
    vol = make_blob_volume(8, 24, 20, seed=21)
    cfg = _cfg(boundary)
    full = denoise(vol, cfg, device="cpu").numpy()

    ckpt = CheckpointManager(str(tmp_path), cfg, vol)

    def save(i, v):
        if i < start_pass:
            ckpt.save_pass(i, v)

    denoise(vol, cfg, on_pass=save, device="cpu")
    resumed = CheckpointManager(str(tmp_path), cfg, vol).load_latest()
    assert resumed is not None
    nxt, state, mean = resumed
    assert nxt == start_pass and state.dtype == np.float32
    assert mean.dtype == np.float32 and mean == volume_mean(vol)
    if start_pass == 3:
        # the finished volume: no pass may run
        def boom(*a, **k):
            raise AssertionError("a pass ran after the last checkpoint")
        monkeypatch.setattr(pipeline, "of_pass_padded", boom)
    out = denoise(state, cfg, start_pass=nxt, mean_val=mean, device="cpu")
    np.testing.assert_array_equal(out.numpy(), full)


def test_manifest_mean_is_volume_mean_bit_for_bit(tmp_path):
    vol = make_blob_volume(8, 24, 20, seed=26) * np.float32(1.37) + 0.1
    ckpt = CheckpointManager(str(tmp_path), _cfg(), vol)
    ckpt.save_pass(0, torch.from_numpy(vol))   # a tensor is saved as well
    with open(tmp_path / MANIFEST) as f:
        manifest = json.load(f)
    assert manifest["completed_pass"] == 0
    assert np.float32(manifest["mean"]) == volume_mean(vol)
    assert np.float32(manifest["mean"]).tobytes() == volume_mean(vol).tobytes()
    # what denoise pads with when given the array and no mean
    assert pipeline._mean(vol, Boundary.MEAN, None) == volume_mean(vol)


def test_manifest_rejects_other_config(tmp_path):
    vol = make_blob_volume(8, 24, 24, seed=22)
    CheckpointManager(str(tmp_path), _cfg(), vol).save_pass(0, vol)
    other = dataclasses.replace(_cfg(), sigma=(1.0, 1.0, 1.0))
    assert CheckpointManager(str(tmp_path), other, vol).load_latest() is None
    assert CheckpointManager(str(tmp_path), _cfg(), vol).load_latest() is not None


def test_manifest_rejects_other_input(tmp_path):
    vol = make_blob_volume(8, 24, 24, seed=23)
    CheckpointManager(str(tmp_path), _cfg(), vol).save_pass(0, vol)
    assert CheckpointManager(str(tmp_path), _cfg(), vol + 1.0).load_latest() is None


class _Stop(Exception):
    pass


def test_cli_resumes_after_an_interruption(tmp_path, monkeypatch):
    vol = make_blob_volume(8, 24, 20, seed=27)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    args = ["-i", str(src), "-s", "1", "1", "1", "-l", "1",
            "--max_displacement", "4", "--boundary", "mean", "--device", "cpu"]
    assert cli.main([*args, "-o", str(tmp_path / "ref.mrc")]) == 0
    ref, _ = read_mrc(tmp_path / "ref.mrc")

    ck = tmp_path / "ck"
    save_pass = checkpoint.CheckpointManager.save_pass
    saved, ran = [], []

    def stop_after_pass_1(self, i, v):
        save_pass(self, i, v)
        saved.append(i)
        if i == 1:
            raise _Stop

    monkeypatch.setattr(checkpoint.CheckpointManager, "save_pass",
                        stop_after_pass_1)
    with pytest.raises(_Stop):
        cli.main([*args, "--checkpoint_dir", str(ck), "-o", str(tmp_path / "o.mrc")])
    assert saved == [0, 1] and not (tmp_path / "o.mrc").exists()

    monkeypatch.setattr(checkpoint.CheckpointManager, "save_pass", save_pass)
    of_pass_padded = pipeline.of_pass_padded
    monkeypatch.setattr(pipeline, "of_pass_padded",
                        lambda *a: ran.append(a[0].shape) or of_pass_padded(*a))
    assert cli.main([*args, "--checkpoint_dir", str(ck),
                     "-o", str(tmp_path / "o.mrc")]) == 0
    # only the X pass ran: its padded stack is (X + 2*ks2, Z, Y)
    assert ran == [(20 + 8, 8, 24)]
    out, _ = read_mrc(tmp_path / "o.mrc")
    np.testing.assert_array_equal(out, ref)
    assert list(ck.iterdir()) == []

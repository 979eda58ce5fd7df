"""Pass-boundary checkpoint and resume.

The port's copy of ``flowdenoising_tpu/utils/checkpoint.py``: after each
completed axis pass the volume is written (``pass{i}.mrc``) beside a
manifest that binds it to the input and the configuration, replaced
atomically, so an interrupted run restarts at the last completed pass.
A manifest whose last pass is the final (X) pass hands back the finished
volume (``next_pass_index`` 3), so a restart after the filter succeeded
runs no pass.

The manifest's ``mean`` is the MEAN boundary's fill value exactly as the
pipeline uses it: the float32 ``volume_mean`` of the input, written as a
JSON number that reads back to the same float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FilterConfig
from flowdenoising_tpu_torch.core.pipeline import volume_mean
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc

MANIFEST = "manifest.json"


def _config_key(cfg: FilterConfig, input_digest: str) -> str:
    payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256((payload + input_digest).encode()).hexdigest()[:16]


def volume_digest(vol) -> str:
    """Cheap content fingerprint: shape/dtype + strided sample hash (the
    JAX package's, so both name the same array alike)."""
    vol = np.asarray(vol)
    h = hashlib.sha256()
    h.update(str(vol.shape).encode())
    h.update(str(vol.dtype).encode())
    flat = vol.reshape(-1)
    stride = max(1, flat.size // 65536)
    h.update(np.ascontiguousarray(flat[::stride]).tobytes())
    return h.hexdigest()[:16]


class CheckpointManager:
    """Checkpoints of one run: ``input_vol`` (array or memmap) and ``cfg``
    name the run; ``mean`` is the input's ``volume_mean`` (computed when
    not given)."""

    def __init__(self, directory: str, cfg: FilterConfig, input_vol,
                 mean=None):
        self.dir = directory
        self.key = _config_key(cfg, volume_digest(input_vol))
        self.mean = np.float32(volume_mean(input_vol) if mean is None else mean)
        os.makedirs(directory, exist_ok=True)

    def _pass_path(self, i: int) -> str:
        return os.path.join(self.dir, f"pass{i}.mrc")

    def save_pass(self, i: int, vol) -> None:
        """Write pass i's canonical (Z, Y, X) volume (a tensor on any
        device, or an array), then the manifest naming it."""
        if isinstance(vol, torch.Tensor):
            vol = vol.detach().to("cpu", torch.float32).numpy()
        write_mrc(self._pass_path(i), np.asarray(vol, np.float32))
        manifest = {"key": self.key, "completed_pass": i,
                    "mean": float(self.mean)}
        tmp = os.path.join(self.dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.dir, MANIFEST))
        logging.info(f"checkpointed pass {i} -> {self._pass_path(i)}")

    def load_latest(self):
        """(next_pass_index, volume, input mean as float32) or None; the
        finished volume with ``next_pass_index`` 3 after the last pass."""
        path = os.path.join(self.dir, MANIFEST)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("key") != self.key:
            logging.info("checkpoint manifest does not match this "
                         "input/config; ignoring")
            return None
        i = min(int(manifest["completed_pass"]), 2)
        vol, _ = read_mrc(self._pass_path(i))
        if i >= 2:
            logging.info(f"all passes checkpointed; using finished volume "
                         f"from {self._pass_path(i)}")
        else:
            logging.info(f"resuming after pass {i} from {self._pass_path(i)}")
        return (i + 1, np.asarray(vol, np.float32),
                np.float32(manifest.get("mean", self.mean)))

    def clear(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("pass") or name == MANIFEST:
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

"""The port's Farneback flow against the JAX package's (and against cv2),
on the CPU, with the flow bars of tests/test_farneback.py: max error
< 1e-3 px, mean error < 1e-5 px."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops.farneback import farneback_flow as j_farneback_flow

from flowdenoising_tpu_torch.config import FlowConfig, from_reference
from flowdenoising_tpu_torch.ops.farneback import farneback_flow, tap_solver

torch.set_num_threads(1)


def _pair(h=48, w=56, seed=0, dy=1, dx=-2):
    base = make_blob_image(h, w, seed=seed)
    img0 = base[4:4 + h, 4:4 + w].copy()
    img1 = base[4 + dy:4 + dy + h, 4 + dx:4 + dx + w].copy()
    return img0, img1


def _assert_flow_close(out, ref):
    err = np.abs(np.asarray(out) - np.asarray(ref))
    assert err.max() < 1e-3, f"max {err.max()}"
    assert err.mean() < 1e-5, f"mean {err.mean()}"


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("max_displacement", [8, None])
def test_matches_jax(seeded, max_displacement):
    # levels=2 with min_size=8: three pyramid levels with per-level d_k
    img0, img1 = _pair(seed=1)
    jc = JFlowConfig(levels=2, min_size=8, max_displacement=max_displacement)
    init = None
    if seeded:
        r = np.random.default_rng(3)
        init = (r.normal(size=img0.shape + (2,)) * 0.5).astype(np.float32)
    ref = j_farneback_flow(jnp.asarray(img1), jnp.asarray(img0), jc,
                           None if init is None else jnp.asarray(init))
    out = farneback_flow(torch.from_numpy(img1), torch.from_numpy(img0),
                         from_reference(jc),
                         None if init is None else torch.from_numpy(init))
    assert out.shape == (48, 56, 2)
    _assert_flow_close(out.numpy(), ref)


@pytest.mark.parametrize("levels,winsize", [(0, 5), (3, 5), (3, 15)])
def test_matches_cv2(levels, winsize):
    img0, img1 = _pair(64, 64, seed=0, dy=1, dx=-1)
    f_cv = cv2.calcOpticalFlowFarneback(
        prev=img0, next=img1, flow=None, pyr_scale=0.5, levels=levels,
        winsize=winsize, iterations=3, poly_n=5, poly_sigma=1.2, flags=0)
    cfg = FlowConfig(levels=levels, winsize=winsize, use_initial_flow=False,
                     max_displacement=None)
    out = farneback_flow(torch.from_numpy(img1), torch.from_numpy(img0), cfg)
    _assert_flow_close(out.numpy(), f_cv)


def test_tap_solver_equals_direct_flow():
    # the per-pass solver windows into one pyramid of the whole stack; the
    # result must equal solving the same slices directly
    r = np.random.default_rng(4)
    base = make_blob_image(40, 44, seed=5)
    stack = np.stack([base[i:i + 40, 2 * i:2 * i + 44] for i in range(6)])
    stack += r.normal(size=stack.shape).astype(np.float32)
    cfg = FlowConfig(levels=2, min_size=8)
    solve = tap_solver(torch.from_numpy(stack), 2, 3, cfg)
    init = torch.from_numpy((r.normal(size=(3, 2, 40, 44)) * 0.3).astype(np.float32))
    out = solve(0, init)
    ref = farneback_flow(torch.from_numpy(stack[0:3]), torch.from_numpy(stack[2:5]),
                         cfg, init.permute(0, 2, 3, 1))
    torch.testing.assert_close(out.permute(0, 2, 3, 1), ref, atol=0, rtol=0)

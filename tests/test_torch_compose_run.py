"""K-compose-run's plain version and the compose pass that runs it, on the
CPU.

- ``compose_run_plain`` (what ``compose_run`` runs on a CPU tensor) equals
  the per-tap chain of ``compose_tap`` at atol 0, in float32, with bf16
  sources and with the bf16 carry, at a bound and with none, with two link
  stacks and with the symmetric sign.
- The chain against a chain of the JAX package's ``compose_tap_pallas`` in
  interpret mode, ks2 = 3 taps a run, on tests/test_torch_compose.py's
  ``_setup`` shapes.
- ``of_pass_padded`` in compose mode equals the per-tap pass it replaced
  (``_per_tap_composed``, built from ``compose_tap``) bit for bit in every
  configuration: float32, ``dtype`` bf16, ``precision`` bf16, the fast
  mode, symmetric, no bound, and each boundary.
- ``compose_run``'s argument checks, and a large sigma (ks2 = 40).

The CUDA kernel is held against ``compose_run_plain`` on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu.ops.pallas.compose import compose_tap_pallas

from flowdenoising_tpu_torch.config import Boundary, FlowConfig
from flowdenoising_tpu_torch.core.axis_filter import (
    _estimation_stack, of_pass_padded, pad_stack)
from flowdenoising_tpu_torch.kernels import get_gaussian_kernel
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.blur import rounded
from flowdenoising_tpu_torch.ops.compose import (
    compose_run, compose_run_plain, compose_tap)
from flowdenoising_tpu_torch.ops.farneback import (
    flow_from_pyramids, polyexp_pyramid)

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _per_tap_run(adj_fwd, adj_bwd, nb, acc, weights, d, round_carry=False):
    """The compose pass's tap loop as it was before K-compose-run: one
    ``compose_tap`` a tap on a flow buffer, ``-adj_fwd`` materialised for
    symmetric adjacent flows.  Returns a new accumulator."""
    ks2 = len(weights) // 2
    acc = acc.clone()
    adj_bwd = -adj_fwd if adj_bwd is None else adj_bwd
    flow = torch.zeros((acc.shape[0], 2) + tuple(acc.shape[1:]))
    for sign, adj, shift in ((-1, adj_bwd, 0), (+1, adj_fwd, -1)):
        flow.zero_()
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            compose_tap(adj, flow, nb, acc, weights[ks2 * (sign > 0) + j - 1],
                        d, start + shift, start, round_carry=round_carry)
    return acc


def _per_tap_composed(padded, taps, flow_cfg):
    """``_of_pass_composed`` as it was before K-compose-run, on the CPU."""
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    d = flow_cfg.max_displacement
    dtype = getattr(torch, flow_cfg.dtype)
    padded = padded.to(dtype)
    adj_cfg = flow_cfg
    if flow_cfg.adjacent_displacement is not None and d is not None:
        adj_cfg = dataclasses.replace(
            flow_cfg, max_displacement=min(d, flow_cfg.adjacent_displacement))
    r_levels = polyexp_pyramid(_estimation_stack(padded, flow_cfg), flow_cfg)
    lo = [r[:-1] for r in r_levels]
    hi = [r[1:] for r in r_levels]
    src = (BF16 if flow_cfg.precision == "bfloat16" and d is not None
           else torch.float32)
    adj_fwd = flow_from_pyramids(lo, hi, adj_cfg, None).to(dtype).to(src)
    adj_bwd = (None if flow_cfg.symmetric_adjacent else
               flow_from_pyramids(hi, lo, adj_cfg, None).to(dtype).to(src))
    acc = (padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)).float()
    weights = [rounded(taps[ks2 + s * j], dtype)
               for s in (-1, +1) for j in range(1, ks2 + 1)]
    return _per_tap_run(adj_fwd, adj_bwd, padded.to(src), acc, weights, d,
                        round_carry=dtype != torch.float32)


def _stacks(n, ks2, h, w, seed, src=torch.float32):
    """Link stacks of scale 0.6 (adjacent drift), a padded stack of scale
    ~50, a center accumulator and 2*ks2 weights."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    fwd = t(r.normal(size=(n + 2 * ks2 - 1, 2, h, w)) * 0.6).to(src)
    bwd = t(r.normal(size=(n + 2 * ks2 - 1, 2, h, w)) * 0.6).to(src)
    nb = t(r.normal(size=(n + 2 * ks2, h, w)) * 50).to(src)
    acc = t(r.normal(size=(n, h, w)) * 20)
    weights = [float(np.float32(x)) for x in r.uniform(0.01, 0.2, 2 * ks2)]
    return fwd, bwd, nb, acc, weights


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4, None])
@pytest.mark.parametrize("round_carry", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_run_equals_per_tap_chain(src, d, round_carry, symmetric):
    fwd, bwd, nb, acc, weights = _stacks(3, 3, 20, 24, seed=7,
                                         src=getattr(torch, src))
    bwd = None if symmetric else bwd
    ref = _per_tap_run(fwd, bwd, nb, acc, weights, d, round_carry)
    out = compose_run_plain(fwd, bwd, nb, acc, weights, d, round_carry)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    # the wrapper: the plain version on a CPU tensor, in place, no launch
    before = dict(K.LAUNCHES)
    acc_io = acc.clone()
    assert compose_run(fwd, bwd, nb, acc_io, weights, d, round_carry) is acc_io
    assert K.LAUNCHES == before
    torch.testing.assert_close(acc_io, ref, atol=0, rtol=0)
    if round_carry:
        assert torch.equal(out, out.to(BF16).float())


@pytest.mark.parametrize("d", [3, 6])
def test_run_matches_pallas_chain(d):
    # ks2 = 3 taps a run on the _setup shapes (b 2, 24 x 40); each JAX step
    # is compose_tap_pallas in interpret mode.  Measured: the accumulator
    # (scale ~20, neighbours ~50) within 7.8e-5 (d 3) and 1.9e-4 (d 6) of
    # the Pallas chain; the bar is the JAX compose kernel test's 1e-4 a
    # tap, over the 2*ks2 taps.
    ks2, n, h, w = 3, 2, 24, 40
    fwd, bwd, nb, acc, weights = _stacks(n, ks2, h, w, seed=d)
    ar = jnp.asarray(acc.numpy())
    for sign, adj in ((-1, bwd), (+1, fwd)):
        fr = jnp.zeros((n, h, w, 2), jnp.float32)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            lp = start - 1 if sign > 0 else start
            link = np.moveaxis(adj[lp:lp + n].numpy(), 1, -1)
            fr, ar = compose_tap_pallas(
                jnp.asarray(link), fr, jnp.asarray(nb[start:start + n].numpy()),
                ar, weights[ks2 * (sign > 0) + j - 1], d, interpret=True)
    out = compose_run_plain(fwd, bwd, nb, acc, weights, d)
    err = float(np.abs(out.numpy() - np.asarray(ar)).max())
    print(f"compose run vs Pallas chain, d={d}: acc max {err:.3g}")
    assert err <= 2 * ks2 * 1e-4


@pytest.fixture(scope="module")
def vol():
    return torch.from_numpy(make_blob_volume(8, 32, 28, seed=2))


@pytest.mark.parametrize("boundary,flow", [
    (Boundary.WRAP, {}),
    (Boundary.MEAN, {"dtype": "bfloat16"}),
    (Boundary.REPLICATE, {"precision": "bfloat16"}),
    (Boundary.WRAP, {"dtype": "bfloat16", "precision": "bfloat16",
                     "symmetric_adjacent": True}),
    (Boundary.MEAN, {"symmetric_adjacent": True, "adjacent_displacement": 2}),
    (Boundary.REPLICATE, {"max_displacement": None}),
    (Boundary.WRAP, {"max_displacement": None, "symmetric_adjacent": True}),
], ids=["f32-wrap", "dtype_bf16-mean", "precision_bf16-replicate",
        "fast-wrap", "symmetric-mean", "unbounded-replicate",
        "unbounded-symmetric-wrap"])
def test_pass_equals_per_tap_pass(vol, boundary, flow):
    taps = get_gaussian_kernel(1.0)
    cfg = FlowConfig(levels=1, min_size=8, tap_mode="compose",
                     **{"max_displacement": 4, **flow})
    padded = pad_stack(vol, len(taps) // 2, boundary)
    before = dict(K.LAUNCHES)
    out = of_pass_padded(padded, taps, cfg)
    assert K.LAUNCHES == before
    ref = _per_tap_composed(padded, taps, cfg)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_large_sigma_runs_through_the_plain_version():
    # the CLI takes any sigma and sizes the kernel at 4 sigma: sigma 10 is
    # ks2 40, which the run takes as it takes 8
    taps = get_gaussian_kernel(10.0)
    ks2 = len(taps) // 2
    assert ks2 == 40
    fwd, _, nb, acc, _ = _stacks(2, ks2, 8, 10, seed=11)
    weights = [float(np.float32(taps[ks2 + s * j]))
               for s in (-1, +1) for j in range(1, ks2 + 1)]
    ref = _per_tap_run(fwd, None, nb, acc, weights, 8)
    out = compose_run(fwd, None, nb, acc.clone(), weights, 8)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_run_checks_its_arguments():
    fwd, bwd, nb, acc, weights = _stacks(2, 2, 8, 8, seed=1)
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd, bwd, nb, acc, weights[:3], 4)      # odd weights
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd, bwd, nb[1:], acc, weights, 4)      # short nb
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd[1:], bwd, nb, acc, weights, 4)      # short link
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd, bwd[:, :1], nb, acc, weights, 4)   # one channel
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd, bwd, nb, acc[:, :4], weights, 4)   # plane size
    with pytest.raises(ValueError, match="expected"):
        compose_run(fwd, bwd, nb, acc[0], weights, 4)       # no batch axis
    with pytest.raises(ValueError, match="no kernel"):
        compose_run(fwd.to("meta"), None, nb.to("meta"), acc.to("meta"),
                    weights, 4)
    # no taps: the accumulator stays the center
    out = compose_run(fwd[:1], None, nb[:2], acc, [], 4)
    torch.testing.assert_close(out, acc, atol=0, rtol=0)

"""The port's auto displacement probe against the JAX package's, on the
CPU, on the volumes of tests/test_autodisp.py: the same probe groups
(plane pairs resized to the same bucket shapes), the same clamp-cost
curves, unbounded-flow errors (``base``) and identity-warp errors
(``ident``), and the same picks.

Tolerances, measured on these volumes:
- against the JAX package's compiled probe program, CURVE_RTOL = 5e-3
  relative (largest difference 3.5e-3, on the calm volume's axis-0 groups,
  whose errors are small, 0.3-0.4 grey levels): the compiled program
  itself differs this much from the same JAX operations run one by one;
- against those operations run one by one (``farneback_flow``,
  ``warp_slices``, the group means), EAGER_RTOL = 1e-5: there the flows
  are bit-identical on the CPU and only the float32 means differ.
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from test_autodisp import make_shift_volume
import jax.numpy as jnp

from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.core import autodisp as JA
from flowdenoising_tpu.ops.farneback import farneback_flow as j_farneback_flow
from flowdenoising_tpu.ops.warp import warp_slices as j_warp_slices

from flowdenoising_tpu_torch.config import FilterConfig, from_reference
from flowdenoising_tpu_torch.core import autodisp as A

torch.set_num_threads(1)

CURVE_RTOL = 5e-3
EAGER_RTOL = 1e-5


def _probe_both(vol, sigma=(2.0, 2.0, 2.0)):
    """Run both probes, recording every ``_run_probe`` call (inputs and
    per-group results, escalations included); returns (jax calls, port
    calls, jax pick, port pick)."""
    jcfg = JFilterConfig(sigma=sigma)
    calls = {"jax": [], "port": []}
    j_run, p_run = JA._run_probe, A._run_probe

    def j_rec(resized, ladders, flow_cfg):
        out = j_run(resized, ladders, flow_cfg)
        calls["jax"].append((resized, ladders, out))
        return out

    def p_rec(resized, ladders, flow_cfg, device):
        out = p_run(resized, ladders, flow_cfg, device)
        calls["port"].append((resized, ladders, out))
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JA, "_run_probe", j_rec)
        mp.setattr(A, "_run_probe", p_rec)
        jpick = JA.probe_displacement(vol, jcfg)
        ppick = A.probe_displacement(vol, from_reference(jcfg), device="cpu")
    finally:
        mp.undo()
    return calls["jax"], calls["port"], jpick, ppick


@pytest.fixture(scope="module")
def calm():
    return _probe_both(make_blob_volume(24, 96, 96, seed=1, drift=0.3))


@pytest.fixture(scope="module")
def shift():
    # 2 px/slice along x: ~16 px at tap distance ks2 = 8, beyond D = 8
    return _probe_both(make_shift_volume(24, 96, 96, px_per_slice=2.0))


def _check_curves(jcalls, pcalls):
    assert len(pcalls) == len(jcalls)
    worst = 0.0
    for (jres, jlad, jout), (pres, plad, pout) in zip(jcalls, pcalls):
        assert [tuple(x) for x in plad] == [tuple(x) for x in jlad]
        for jg, pg in zip(jres, pres):   # resized (t, r, su, sv)
            np.testing.assert_array_equal(pg[0], jg[0])
            np.testing.assert_array_equal(pg[1], jg[1])
            assert pg[2:] == jg[2:]
        for (jc, jb, ji), (pc, pb, pi) in zip(jout, pout):
            want = np.asarray(jc + [jb, ji])
            got = np.asarray(pc + [pb, pi])
            np.testing.assert_allclose(got, want, rtol=CURVE_RTOL, atol=0)
            worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    print(f"largest relative curve difference {worst:.3g}")


@pytest.mark.parametrize("case", ["calm", "shift"])
def test_curves_match_jax(case, request):
    jcalls, pcalls, _, _ = request.getfixturevalue(case)
    _check_curves(jcalls, pcalls)


def test_probe_errors_match_jax_ops_one_by_one(calm):
    # the calm volume's axis-0 far group, through the JAX operations run
    # one by one, the way the compiled probe program composes them
    jcalls, pcalls, _, _ = calm
    t, r, su, sv = jcalls[0][0][0]
    ladder = jcalls[0][1][0]
    jflow = j_farneback_flow(jnp.asarray(r), jnp.asarray(t),
                             JA._probe_cfg(JFilterConfig().flow))

    def err(f):
        return float(np.mean(np.abs(np.asarray(j_warp_slices(jnp.asarray(r), f))
                                    - t), dtype=np.float64))

    bnd = [jnp.asarray([d / su, d / sv], jnp.float32) for d in ladder]
    want = [err(jnp.clip(jflow, -b, b)) for b in bnd] + [
        err(jflow), float(np.mean(np.abs(r - t), dtype=np.float64))]
    curve, base, ident = pcalls[0][2][0]
    np.testing.assert_allclose(curve + [base, ident], want, rtol=EAGER_RTOL,
                               atol=0)


def test_calm_volume_picks_jax_small_bound(calm):
    _, _, jpick, ppick = calm
    assert ppick == jpick
    max_d, adj_d = ppick
    assert max_d <= 8 and adj_d <= 4 and adj_d <= max_d


def test_fast_drift_picks_jax_raised_bound(shift):
    _, _, jpick, ppick = shift
    assert ppick == jpick
    max_d, adj_d = ppick
    assert max_d >= 12
    assert adj_d <= 6   # adjacent motion is still only ~2 px


def test_pick_bound_normalizes_by_tracking_benefit():
    # tests/test_autodisp.py's curves: a clamp cost small against the base
    # error but large against the tracking benefit pushes the pick up
    ladder = A._D_LADDER
    base, ident = 23.0, 31.0
    curve = [base + c for c in (4.3, 3.4, 2.5, 1.6, 1.1, 0.4, 0.09, 0.0)]
    assert A._pick_bound([curve], [(base, ident)], ladder, "x") == \
        JA._pick_bound([curve], [(base, ident)], ladder, "x") == 32
    flat = [base] * len(ladder)
    assert A._pick_bound([flat], [(base, ident)], ladder, "x") == ladder[0]
    assert A._pick_bound([[5.0] * len(ladder)], [(5.0, 5.0)], ladder,
                         "x") == ladder[0]
    assert (A._D_LADDER, A._ADJ_LADDER, A._BENEFIT_TOL, A._N_PAIRS,
            A._UNTRACKED_FRAC) == (JA._D_LADDER, JA._ADJ_LADDER,
                                   JA._BENEFIT_TOL, JA._N_PAIRS,
                                   JA._UNTRACKED_FRAC)


def test_adjacent_floor_independent_of_far(monkeypatch):
    """An uninformative adjacent probe floors the adjacent pick even when
    the far curve is informative (tests/test_autodisp.py's case)."""
    def fake_run_probe(resized, ladders, flow_cfg, device):
        out = []
        for lad in ladders:
            if tuple(lad) == A._D_LADDER:
                out.append(([2.0, 2.0] + [1.0] * (len(lad) - 2), 1.0, 10.0))
            else:
                out.append(([9.6] * len(lad), 9.6, 10.0))
        return out

    monkeypatch.setattr(A, "_run_probe", fake_run_probe)
    vol = make_blob_volume(12, 32, 32, seed=44)
    assert A.probe_displacement(vol, FilterConfig(), device="cpu") == (8, 4)


@pytest.mark.parametrize("h,w", [(96, 96), (160, 512), (512, 160), (300, 280)])
def test_bucket_shapes_match_jax(h, w):
    for e in (128, 256):
        assert A._bucket_shape(h, w, e) == JA._bucket_shape(h, w, e)


def test_resolve_fills_config(monkeypatch):
    monkeypatch.setattr(A, "probe_displacement",
                        lambda vol, cfg, device=None: (12, 3))
    cfg = FilterConfig(sigma=(1.5, 1.5, 1.5))
    out = A.resolve_auto_displacement(np.zeros((4, 8, 8), np.float32), cfg)
    assert (out.flow.max_displacement, out.flow.adjacent_displacement) == (12, 3)
    assert out.sigma == cfg.sigma and out.flow.levels == cfg.flow.levels

"""The port's bf16 fast mode (``--dtype bfloat16``, ``--precision
bfloat16``) against the JAX package's TPU path, on the CPU.

The reference is the TPU path, not JAX's CPU path: on the CPU
``pallas_supported()`` is False, so JAX's bf16 pass packs nothing and runs
Farneback and the warps in bf16 arithmetic (``test_jax_cpu_path_diverges``
measures how far that lands).  So the oracles here are assembled from the
JAX package's own functions, run eagerly (op by op, each rounding to bf16
as the TPU path's ops do), with its Pallas kernels in interpret mode:

- the packed kernels (``packed=True``) against the port's plain forms,
  which the wrappers run on CPU tensors, at the shapes of the JAX package's
  packed tests and at their bars or tighter;
- the solve-mode tap solver against ``prepped_tap_solver``, with a level on
  the JAX tiny route;
- the compose pass against the flow_from_pyramids level loop plus the
  prepped compose tap chain;
- the solve pass and a 3-pass ``denoise`` against the same kind of oracle,
  with the PSNR bar set by measurement and reported beside the oracle's
  own bf16-against-float32 PSNR;
- the CLI's flags, and the refusal of what is not ported.

Each test prints its measured error.  The CUDA kernels' packed forms are
held to their plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas import umuf as JU
from flowdenoising_tpu.ops.pallas.compose import compose_tap_pallas
from flowdenoising_tpu.ops.pallas.update_matrices import update_matrices_pallas

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig, from_reference
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.compose import compose_tap, compose_tap_plain

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _cf(x, dtype=torch.float32):
    """Channels-last array -> channel-first CPU tensor of ``dtype``."""
    a = np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, -3))
    return torch.from_numpy(a).to(dtype)


def _expansions(b, h, w, seed, flow_scale=1.5):
    """tests/test_pallas_packed.py's operands: channels-last expansions of
    noise images of scale 40 and a flow N(0, flow_scale)."""
    r = np.random.default_rng(seed)
    img0 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    img1 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    flow = jnp.asarray((r.normal(size=(b, h, w, 2)) * flow_scale).astype(np.float32))
    return JF.poly_expand(img0), JF.poly_expand(img1), flow


def _err(out, ref):
    e = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    return float(e.max()), float(e.mean())


# ---- the packed kernels against the Pallas kernels (interpret mode) ----

@pytest.mark.parametrize("seed,scale,d", [(0, 1.5, 4), (3, 6.0, 3), (4, 0.0, 2)])
def test_um_packed_plain_matches_pallas(seed, scale, d):
    # K-um-bf16's plain form (r1 in bfloat16) against _um_kernel packed;
    # the JAX package's packed bar is atol 2e-3, rtol 1e-4
    r0, r1, flow = _expansions(2, 24, 40, seed, scale)
    ref = np.asarray(update_matrices_pallas(r0, r1, flow, d, interpret=True,
                                            packed=True))
    out = F.update_matrices(_cf(r0), _cf(r1, BF16), _cf(flow), d)
    out = np.moveaxis(out.numpy(), -3, -1)
    print(f"K-um-bf16 plain vs Pallas packed, d={d}: max {_err(out, ref)[0]:.3g}")
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("winsize,d,iters", [(5, 4, 1), (5, 4, 3), (7, 3, 1)])
def test_umuf_packed_plain_matches_pallas(winsize, d, iters):
    # K-umuf-bf16's plain form against _umuf_kernel packed; the JAX
    # package's packed bar is atol 5e-3, rtol 1e-3
    r0, r1, flow = _expansions(2, 24, 40, winsize * 10 + d)
    ref = np.asarray(JU.umuf_iterate(r0, r1, flow, iters, d, winsize,
                                     interpret=True, packed=True))
    out = F.umuf_iterate(_cf(r0), _cf(r1, BF16), _cf(flow), iters, d, winsize)
    out = np.moveaxis(out.numpy(), -3, -1)
    print(f"K-umuf-bf16 plain vs Pallas packed, ws={winsize} d={d} "
          f"iters={iters}: max {_err(out, ref)[0]:.3g}")
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("d,scale,seed", [(3, 1.5, 0), (4, 8.0, 3)])
def test_compose_packed_plain_matches_pallas(d, scale, seed):
    # K-compose-bf16's plain form (link and neighbour in bfloat16) against
    # _compose_kernel packed, on tests/test_pallas_compose.py's operands, at
    # the float32 compose bars (flow atol 1e-5, accumulator atol 1e-4)
    r = np.random.default_rng(seed)
    link = (r.normal(size=(2, 24, 40, 2)) * 0.6).astype(np.float32)
    flow = (r.normal(size=(2, 24, 40, 2)) * scale).astype(np.float32)
    nb = r.normal(size=(2, 24, 40)).astype(np.float32) * 50
    acc = r.normal(size=(2, 24, 40)).astype(np.float32)
    fr, ar = compose_tap_pallas(jnp.asarray(link), jnp.asarray(flow),
                                jnp.asarray(nb), jnp.asarray(acc), 0.13, d,
                                interpret=True, packed=True)
    fo, ao = compose_tap_plain(_cf(link, BF16), _cf(flow),
                               torch.from_numpy(nb).to(BF16),
                               torch.from_numpy(acc), float(np.float32(0.13)), d)
    fo = np.moveaxis(fo.numpy(), 1, -1)
    print(f"K-compose-bf16 plain vs Pallas packed, d={d}: flow max "
          f"{_err(fo, fr)[0]:.3g}, acc max {_err(ao.numpy(), ar)[0]:.3g}")
    np.testing.assert_allclose(fo, np.asarray(fr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ao.numpy(), np.asarray(ar), atol=1e-4, rtol=0)


def test_compose_round_carry_rounds_after_the_neighbour_sample():
    # round_carry stores flow' and acc' rounded to bf16, but the neighbour
    # is sampled at the unrounded flow' (compose.py:569-574); the CPU
    # wrapper counts no launch of either form
    r = np.random.default_rng(2)
    n, h, w = 2, 16, 20
    link = torch.from_numpy((r.normal(size=(n + 2, 2, h, w)) * 0.7).astype(np.float32))
    nb = torch.from_numpy((r.normal(size=(n + 3, h, w)) * 40).astype(np.float32))
    flow = torch.from_numpy((r.normal(size=(n, 2, h, w)) * 2).astype(np.float32))
    acc = torch.from_numpy((r.normal(size=(n, h, w)) * 30).astype(np.float32))
    f32, a32 = compose_tap_plain(link[1:1 + n], flow, nb[2:2 + n], acc, 0.25, 4)
    before = dict(K.LAUNCHES)
    for src in (torch.float32, BF16):
        fk, ak = flow.clone(), acc.clone()
        compose_tap(link.to(src), fk, nb.to(src), ak, 0.25, 4, 1, 2,
                    round_carry=True)
        fr, ar = compose_tap_plain(link[1:1 + n].to(src), flow,
                                   nb[2:2 + n].to(src), acc, 0.25, 4)
        torch.testing.assert_close(fk, fr.to(BF16).float(), atol=0, rtol=0)
        torch.testing.assert_close(ak, ar.to(BF16).float(), atol=0, rtol=0)
    assert K.LAUNCHES == before
    assert not torch.equal(fk, f32) and torch.equal(fk, fk.to(BF16).float())


def test_packed_forms_are_the_float32_forms_on_a_rounded_source():
    # the plain version of every packed form: the source rounded to bf16,
    # sampled in float32 -- K-umuf-bf16 equals K-umuf on the rounded r1
    r0, r1, flow = _expansions(2, 20, 24, 9)
    r1b = _cf(r1, BF16)
    out = F.umuf_iterate(_cf(r0), r1b, _cf(flow), 3, 4, 5)
    ref = F.umuf_iterate(_cf(r0), r1b.float(), _cf(flow), 3, 4, 5)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


# ---- the route: where the JAX package packs ----

@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_packing_follows_the_jax_tiny_route(precision):
    # packed exactly where the JAX package runs its Pallas kernel packed:
    # a finite bound, outside the tiny route (area <= 2048 and d_k <= 4)
    for d in (None, 2, 4, 8, 16):
        jc = JFlowConfig(max_displacement=d, precision=precision)
        cfg = from_reference(jc)
        for k in range(4):
            for hk, wk in ((16, 16), (32, 32), (32, 64), (45, 45), (64, 64),
                           (24, 128), (256, 256)):
                dk = JF._level_displacement(jc, k)
                tiny = (dk is not None and dk <= JF._XLA_LEVEL_MAX_D
                        and hk * wk <= JF._XLA_LEVEL_AREA)
                want = precision == "bfloat16" and dk is not None and not tiny
                assert F._packed_at_level(cfg, k, hk, wk) == want, (d, k, hk, wk)
    # the main path at 256^2, D 8: the 32^2 level (d 2) is never packed;
    # at 512^2 the coarsest level is 64^2, and every level is packed
    cfg = FlowConfig(precision=precision)
    packed = precision == "bfloat16"
    assert [F._packed_at_level(cfg, k, 256 >> k, 256 >> k)
            for k in range(4)] == [packed] * 3 + [False]
    assert [F._packed_at_level(cfg, k, 512 >> k, 512 >> k)
            for k in range(4)] == [packed] * 4


# ---- the solve-mode tap solver against the TPU path's own ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tap_solver_matches_prepped_tap_solver(dtype, monkeypatch):
    # precision bfloat16 with either pass dtype, against prepped_tap_solver
    # (farneback.py:389-471) in interpret mode.  A 64^2 plane at D 4: the
    # 64^2 level is packed (d 5), the 32^2 level takes the tiny route (d 3).
    vol = make_blob_volume(6, 64, 64, seed=1)
    jc = JFlowConfig(max_displacement=4, precision="bfloat16", dtype=dtype)
    cfg = from_reference(jc)
    assert [F._packed_at_level(cfg, k, 64 >> k, 64 >> k)
            for k in range(2)] == [True, False]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    solver = JF.prepped_tap_solver(jnp.asarray(vol).astype(jdt), 2, 2, jc,
                                   interpret=True)
    solve = F.tap_solver(torch.from_numpy(vol).to(tdt), 2, 2, cfg)
    # a seed flow as the pass carries it between taps (in the pass dtype)
    seed = (np.random.default_rng(0).normal(size=(2, 2, 64, 64)) * 0.5
            ).astype(np.float32)
    seed = torch.from_numpy(seed).to(tdt)
    for start, init in ((0, seed), (4, None)):
        ref = solver(start, None if init is None else
                     jnp.asarray(init.float().numpy()).astype(jdt))
        out = solve(start, None if init is None else init.float())
        e_max, e_mean = _err(out.numpy(), ref)
        print(f"tap solver, dtype {dtype}, start {start}: flow max {e_max:.3g}, "
              f"mean {e_mean:.3g}")
        if dtype == "bfloat16" and init is None:
            # Measured 0.090 / 5.4e-5.  It comes from the oracle kernel's
            # rounding of the bilinear weights in phase 1, amplified over
            # the packed level's iterations on the flat bf16 image
            # (test_unseeded_bf16_divergence_is_the_oracles_bilinear_weights):
            # with those weights in the port's phase 1, the solve meets
            # the float32 bars (measured 7.4e-6 / 1.0e-7).
            assert e_max < 0.15 and e_mean < 1e-4
            with monkeypatch.context() as patch:
                patch.setattr(F, "displace_sample_plain", _umuf_kernel_weights)
                weighted = F.tap_solver(torch.from_numpy(vol).to(tdt), 2, 2,
                                        cfg)(start)
            w_max, w_mean = _err(weighted.numpy(), ref)
            print(f"  with the oracle's bilinear weights: flow max "
                  f"{w_max:.3g}, mean {w_mean:.3g}")
            assert w_max < 1e-3 and w_mean < 1e-5
        else:
            # the float32 flow bars of tests/test_farneback.py
            assert e_max < 1e-3 and e_mean < 1e-5


def _umuf_kernel_weights(src, u, v, d):
    """Bilinear sampling at (u, v) clamped to +-d as the JAX package's fused
    Pallas iteration rounds it (``ops/pallas/umuf.py: _gather_term``): per
    row shift s the hat weight wy = max(0, 1 - |v - s|), then w1 = wy * tu,
    w0 = wy - w1 with tu = u - floor(u), and g0 * w0 + g1 * w1 summed over
    the two shifts.  The port, like the JAX package's gather path, lerps
    along x and then along y at the fractions of (x + u, y + v)."""
    b, c, h, w = src.shape
    u, v = u.clamp(-d, d), v.clamp(-d, d)
    iu = torch.floor(u)
    tu = u - iu
    x = torch.arange(w)
    xa = (x + iu.long()).clamp(0, w - 1)
    xb = (x + iu.long() + 1).clamp(0, w - 1)
    rows = torch.arange(h)[:, None]
    flat = src.float().reshape(b, c, h * w)
    acc = torch.zeros(b, c, h, w)
    for k in (0, 1):
        s = torch.floor(v) + k
        wy = torch.clamp(1.0 - (v - s).abs(), min=0.0)
        w1 = wy * tu
        w0 = wy - w1
        yy = (rows + s.long()).clamp(0, h - 1) * w

        def take(xi):
            idx = (yy + xi).reshape(b, 1, h * w).expand(b, c, h * w)
            return flat.gather(2, idx).reshape(b, c, h, w)

        acc = acc + (take(xa) * w0[:, None] + take(xb) * w1[:, None])
    return acc


def test_unseeded_bf16_divergence_is_the_oracles_bilinear_weights(monkeypatch):
    # ROADMAP Queue C: where the unseeded bf16 case of
    # test_tap_solver_matches_prepped_tap_solver (0.090 px) arises.  At the
    # packed 64^2 level (d 5), from the port's flow of the tiny 32^2 level:
    # - the box sum is not it: the oracle's banded-matmul order ("mxu")
    #   and its shift-add order differ by ~1e-6, and on one M the JAX
    #   package's K-uf kernel and the port's phase 2 agree within 1.5e-6
    #   (XLA's CPU code contracts the kernels' multiply-adds into FMAs);
    # - phase 1 is: with the oracle kernel's bilinear weights in the port's
    #   phase 1, the 3 iterations meet the float32 bars (and so does the
    #   whole tap solve, test_tap_solver_matches_prepped_tap_solver); the
    #   port's own sampling equals the JAX package's gather path
    #   (warp.py: bilinear_sample) bit for bit.
    from flowdenoising_tpu.ops.pallas.update_flow import update_flow_pallas
    from flowdenoising_tpu.ops.warp import bilinear_sample
    from flowdenoising_tpu_torch.ops.resize import resize_linear
    from flowdenoising_tpu_torch.ops.warp import displace_sample_plain

    vol = make_blob_volume(6, 64, 64, seed=1)
    jc = JFlowConfig(max_displacement=4, precision="bfloat16", dtype="bfloat16")
    cfg = from_reference(jc)
    pyr = F.polyexp_pyramid(torch.from_numpy(vol).to(BF16), cfg)
    r0, r1, ramp = F._level_operands(cfg, 1, pyr[1][2:4], pyr[1][4:6])
    flow = F.umuf_iterate_plain(r0, r1, torch.zeros(2, 2, 32, 32), 3, 3, 5, ramp)
    flow = (resize_linear(flow, (64, 64)) * 2.0).contiguous()
    r0, r1, _ = F._level_operands(cfg, 0, pyr[0][2:4], pyr[0][4:6])
    assert r1.dtype == BF16

    def cl(t):
        return jnp.asarray(np.moveaxis(t.float().numpy(), -3, -1))

    def cf(a):
        return np.moveaxis(np.asarray(a, np.float32), -1, -3)

    kn = dict(JF._umuf_opts(), eo=0)      # as prepped_tap_solver runs it
    ref = cf(JU.umuf_iterate(cl(r0), cl(r1), cl(flow), 3, 5, 5,
                             interpret=True, packed=True, **kn))
    shift_add = cf(JU.umuf_iterate(cl(r0), cl(r1), cl(flow), 3, 5, 5,
                                   interpret=True, packed=True,
                                   **dict(kn, mxu=False)))
    port = F.umuf_iterate_plain(r0, r1, flow, 3, 5, 5).numpy()
    m = F.update_matrices_plain(r0, r1, flow, 5)
    uf_ref = cf(update_flow_pallas(cl(m), 5, interpret=True))
    monkeypatch.setattr(F, "displace_sample_plain", _umuf_kernel_weights)
    weighted = F.umuf_iterate_plain(r0, r1, flow, 3, 5, 5).numpy()
    monkeypatch.undo()
    e_port, e_box = _err(port, ref), _err(shift_add, ref)
    e_weighted = _err(weighted, ref)
    e_uf = _err(F.update_flow_plain(m, 5).numpy(), uf_ref)
    print(f"packed level, 3 iterations against the oracle: port {e_port}, "
          f"oracle's shift-add box order {e_box}, port with the oracle's "
          f"weights {e_weighted}; one phase 2 on one M {e_uf}")
    assert e_port[0] > 0.05                      # the divergence is here
    assert e_box[0] < 1e-5 and e_uf[0] < 1e-5
    assert e_weighted[0] < 1e-3 and e_weighted[1] < 1e-5
    gx = np.arange(64, dtype=np.float32)
    u = flow[:, 0].clamp(-5, 5).numpy()
    v = flow[:, 1].clamp(-5, 5).numpy()
    gather = bilinear_sample(jnp.asarray(r1.float().numpy()),
                             jnp.asarray(u[:, None] + gx),
                             jnp.asarray(v[:, None] + gx[:, None]))
    np.testing.assert_array_equal(
        displace_sample_plain(r1, flow[:, 0], flow[:, 1], 5).numpy(),
        np.asarray(gather))


# ---- configuration, CLI ----

def test_from_reference_carries_dtype_and_precision():
    jc = JFilterConfig(flow=JFlowConfig(dtype="bfloat16", precision="bfloat16"))
    cfg = from_reference(jc)
    assert (cfg.flow.dtype, cfg.flow.precision) == ("bfloat16", "bfloat16")
    # with no bound too (the split route, tests/test_torch_bf16_nobound.py)
    nobound = from_reference(JFlowConfig(dtype="bfloat16", max_displacement=None))
    assert (nobound.dtype, nobound.max_displacement) == ("bfloat16", None)
    with pytest.raises(ValueError, match="dtype"):
        FlowConfig(dtype="float16")


@pytest.mark.parametrize("flags", [
    [], ["--tap_flow", "compose", "--symmetric_adjacent"]],
    ids=["solve", "compose_symmetric"])
def test_cli_fast_mode_on_cpu(flags, tmp_path):
    # the fast-mode flags run; the output is finite, float32, the library
    # call's, and not the float32 path's
    vol = make_blob_volume(6, 32, 40, seed=4)
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_mrc(src, vol)
    rc = cli.main(["-i", str(src), "-o", str(dst), "-s", "1", "1", "1", "-l",
                   "1", "--max_displacement", "4", "--dtype", "bfloat16",
                   "--precision", "bfloat16", "--device", "cpu", *flags])
    assert rc == 0
    data, _ = read_mrc(dst)
    assert data.dtype == np.float32 and bool(np.isfinite(data).all())
    mode = dict(tap_mode="compose", symmetric_adjacent=True) if flags else {}
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), flow=FlowConfig(
        levels=1, max_displacement=4, dtype="bfloat16", precision="bfloat16",
        **mode))
    np.testing.assert_array_equal(data, denoise(vol, cfg, device="cpu").numpy())
    f32 = denoise(vol, dataclasses.replace(cfg, flow=dataclasses.replace(
        cfg.flow, dtype="float32", precision="float32")), device="cpu").numpy()
    # the TPU path's own bf16 output lies 40-51 dB from float32 on volumes
    # this small (tests/test_torch_bf16_pass.py prints it); 38-41 dB here
    value = psnr(data, f32)
    print(f"CLI fast mode {flags}: PSNR {value:.2f} dB against float32")
    assert not np.array_equal(data, f32) and value > 30.0


def test_bf16_pyramid_equals_jax_eager():
    # the bf16 expansion pyramid (taps, resize weights and the expansion's
    # constants rounded to bf16, every op rounding to bf16) equals the JAX
    # package's run op by op, bit for bit
    vol = make_blob_volume(4, 64, 64, seed=6)
    jc = JFlowConfig(dtype="bfloat16")
    ref = JF.polyexp_pyramid(jnp.asarray(vol).astype(jnp.bfloat16), jc,
                             channel_first=True)
    out = F.polyexp_pyramid(torch.from_numpy(vol).to(BF16), from_reference(jc))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.dtype == BF16
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)))

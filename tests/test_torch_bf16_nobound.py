"""The port's bf16 pass with no displacement bound (``--dtype bfloat16
--max_displacement 0``) against the JAX package's TPU path on the CPU.

With no bound the JAX package's fused kernels do not run
(``flowdenoising_tpu/ops/farneback.py: _iterate_level``): every level runs
the split iteration, phase 1 ``update_matrices(r0, r1, flow, None)`` in XLA
in bf16 arithmetic and phase 2 in the Pallas kernel B5
(``update_flow_pallas``) on a float32 copy of M (the port's plain version
``split_iterate_plain``, which the CPU runs here; the card runs
K-umuf-split, held to it bit for bit by tests/test_torch_cuda.py); every warp is the exact
gather in bf16 (``ops/warp.py: displace_sample``), and the compose pass
runs its tap chain in XLA (``core/axis_filter.py: body_of``, no fused
step).  The oracle is those JAX functions run eagerly, never inside a jit
(eager JAX rounds after each operation), with B5 in interpret mode in place
of the XLA ``update_flow`` that the JAX package's own CPU path calls (it is
not the TPU path: ``tests/test_torch_bf16_pass.py::
test_jax_cpu_path_diverges``).

The inputs are ``make_blob_volume(6, 64, 64)`` at sigma 0.5 (5 taps) and 2
levels, a 261-wide plane, where bf16 pixel coordinates have no fractional
part and no odd integer (past 128 and 256), and a 128 x 512 plane at two
pyramid levels (the seed resize, the zero flow of the coarsest level and
the float32 flows between levels, all past 256).  The passes and the
denoise equal the oracle bit for bit; each test prints the oracle's own
bf16-against-float32 PSNR beside it for scale.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core.axis_filter import pad_stack as j_pad_stack
from flowdenoising_tpu.kernels import get_gaussian_kernels as j_kernels
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops import warp as JW
from flowdenoising_tpu.ops.pallas.update_flow import update_flow_pallas

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import from_reference
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.axis_filter import of_pass_padded
from flowdenoising_tpu_torch.core.pipeline import denoise, denoise_many
from flowdenoising_tpu_torch.core.stream import denoise_streamed
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.warp import displace_sample_xla
from flowdenoising_tpu_torch.parallel.mesh import denoise_sharded, make_mesh

torch.set_num_threads(1)

SIGMA = 0.5            # 5 taps: two a run
# The flows: phase 1 is bit for bit, but B5 in interpret mode (an XLA CPU
# compile) and K-uf's plain version round the solve apart (3.6e-7 on one
# call), which the bf16 coordinates of the next phase 1 can amplify; the
# fused iteration's bar (tests/test_pallas_umuf.py:34)
FLOW_TOL = dict(atol=5e-4, rtol=1e-4)
NOBOUND = dict(dtype="bfloat16", max_displacement=None, levels=2)
BF16 = jnp.bfloat16
# The pass dtype's views of the pipeline (flowdenoising_tpu/core/pipeline.py:
# _axis_views): forward and inverse transposes of the Z, Y and X passes.
VIEWS = [((0, 1, 2), (0, 1, 2)), ((1, 0, 2), (1, 0, 2)), ((2, 0, 1), (1, 2, 0))]


@pytest.fixture(autouse=True, scope="module")
def tpu_update_flow():
    """The JAX package's update_flow as its TPU path runs it: B5 (interpret
    mode) on M, which B5 casts to float32, returning float32."""
    saved = JF.update_flow
    JF.update_flow = lambda m, winsize, sampler="auto": update_flow_pallas(
        m, winsize, interpret=True)
    yield
    JF.update_flow = saved


def jax_of(x):
    """A JAX channels-last array as the port's channel-first tensor."""
    return torch.from_numpy(np.moveaxis(np.asarray(x.astype(jnp.float32)), -1, -3)
                            .copy()).to(getattr(torch, jnp.dtype(x.dtype).name))


def jax_solve_pass(padded, taps, jc, zero_dtype=BF16):
    """The TPU path's solve-mode pass with no bound (axis_filter.py:148-211,
    the branch without the prepped solver), its tap scan as a loop.  Each
    run's first solve is seeded with zeros of ``zero_dtype`` (the JAX
    package's: the pass dtype)."""
    padded = jnp.asarray(padded).astype(BF16)
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    r = JF.polyexp_pyramid(padded, jc)
    r0 = [x[ks2:ks2 + n] for x in r]
    acc = padded[ks2:ks2 + n] * jnp.asarray(taps[ks2], BF16)
    for sign in (-1, +1):
        prev = jnp.zeros((n,) + padded.shape[1:] + (2,), zero_dtype)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            flow = JF.flow_from_pyramids(r0, [x[start:start + n] for x in r],
                                         jc, prev).astype(BF16)
            warped = JW.displace_sample(padded[start:start + n], flow[..., 0],
                                        flow[..., 1], None)
            acc = acc + (warped * jnp.asarray(taps[ks2 + sign * j], BF16)
                         ).astype(BF16)
            prev = flow
    return np.asarray(acc.astype(jnp.float32))


def jax_compose_pass(padded, taps, jc):
    """The TPU path's compose pass with no bound and symmetric adjacent
    flows (axis_filter.py:232-365: ``fused_step`` False), eagerly."""
    padded = jnp.asarray(padded).astype(BF16)
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    r = JF.polyexp_pyramid(padded, jc)
    fwd = JF.flow_from_pyramids([x[:-1] for x in r], [x[1:] for x in r], jc,
                                None).astype(BF16)
    acc = padded[ks2:ks2 + n] * jnp.asarray(taps[ks2], BF16)
    for sign, adj, shift in ((-1, -fwd, 0), (+1, fwd, -1)):
        flow = jnp.zeros((n,) + padded.shape[1:] + (2,), BF16)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            link = jnp.moveaxis(adj[start + shift:start + shift + n], -1, -3)
            warped_link = JW.displace_sample(link, flow[..., 0], flow[..., 1], None)
            flow = (flow + jnp.moveaxis(warped_link, -3, -1)).astype(BF16)
            warped = JW.warp_slices(padded[start:start + n], flow, None)
            acc = acc + (warped * jnp.asarray(taps[ks2 + sign * j], BF16)
                         ).astype(BF16)
    return np.asarray(acc.astype(jnp.float32))


@pytest.fixture(scope="module")
def vol():
    return make_blob_volume(6, 64, 64, seed=2)


@pytest.fixture(scope="module")
def jc():
    return JFlowConfig(**NOBOUND)


@pytest.fixture(scope="module")
def pyramid(vol, jc):
    """The JAX package's bf16 expansion pyramid of the volume's planes and
    of a 3 x 40 x 261 blob stack (levels 0 and 1 of the 64^2 planes; the
    261-wide stack at one level)."""
    wide = make_blob_volume(3, 40, 261, seed=5)
    return (JF.polyexp_pyramid(jnp.asarray(vol).astype(BF16), jc),
            JF.polyexp_pyramid(jnp.asarray(wide).astype(BF16),
                               dataclasses.replace(jc, levels=0)))


def _flow(shape, seed):
    """A channels-last flow N(0, 3) with a band pushed 40 px to the right,
    past the plane's edge."""
    f = np.random.default_rng(seed).normal(size=shape + (2,)).astype(np.float32) * 3
    f[:, :, : shape[2] // 5, 0] += 40
    return f


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("plane", ["64x64", "40x261"])
def test_phase1_matches_jax_bit_for_bit(pyramid, plane, flow_dtype):
    r = pyramid[0][0] if plane == "64x64" else pyramid[1][0]
    r0, r1 = r[:-1], r[1:]
    fj = jnp.asarray(_flow(r0.shape[:-1], seed=1)).astype(flow_dtype)
    ref = JF.update_matrices(r0, r1, fj, None, "auto")
    out = F.update_matrices_xla(jax_of(r0), jax_of(r1), jax_of(fj))
    # a bf16 flow leaves M in bf16; a float32 one promotes it
    assert str(out.dtype) == f"torch.{jnp.dtype(ref.dtype).name}" == f"torch.{flow_dtype}"
    np.testing.assert_array_equal(out.float().numpy(), jax_of(ref).float().numpy())


def test_exact_gather_matches_jax_bit_for_bit(pyramid):
    src = pyramid[1][0][..., 2]                      # (3, 40, 261) bf16
    f = jnp.asarray(_flow(src.shape, seed=3)).astype(BF16)
    ref = JW.displace_sample(src, f[..., 0], f[..., 1], None)
    out = displace_sample_xla(torch.from_numpy(np.asarray(
        src.astype(jnp.float32))).to(torch.bfloat16), *jax_of(f).unbind(1))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_level_iteration_matches_jax(pyramid, jc):
    # level 1 of the 64^2 planes from zeros in bf16, three split iterations
    r = pyramid[0][1]
    r0, r1 = r[:-1], r[1:]
    flow = jnp.zeros(r0.shape[:-1] + (2,), BF16)
    ref = JF._iterate_level(r0, r1, flow, jc, level=1)
    before = dict(K.LAUNCHES)
    out = F.split_iterate(jax_of(r0), jax_of(r1), jax_of(flow), jc.iterations,
                          jc.winsize)
    assert K.LAUNCHES == before    # a CPU tensor: the plain version
    assert out.dtype == torch.float32 and jnp.dtype(ref.dtype) == jnp.float32
    diff = np.abs(out.numpy() - jax_of(ref).numpy())
    print(f"level iteration: max abs diff {diff.max():.3g} px")
    np.testing.assert_allclose(out.numpy(), jax_of(ref).numpy(), **FLOW_TOL)


@pytest.mark.parametrize("seeded", [False, True])
def test_flow_from_pyramids_matches_jax(pyramid, jc, seeded):
    r = pyramid[0]
    lo, hi = [x[:-1] for x in r], [x[1:] for x in r]
    seed = (jnp.asarray(_flow(lo[0].shape[:-1], seed=4) / 8).astype(BF16)
            if seeded else None)
    ref = JF.flow_from_pyramids(lo, hi, jc, seed)
    out = F.flow_from_pyramids([jax_of(x) for x in lo], [jax_of(x) for x in hi],
                               from_reference(jc),
                               None if seed is None else jax_of(seed))
    diff = np.abs(out.numpy() - jax_of(ref).numpy())
    print(f"flow_from_pyramids (seeded {seeded}): max abs diff {diff.max():.3g} px")
    np.testing.assert_allclose(out.numpy(), jax_of(ref).numpy(), **FLOW_TOL)


def _padded(vol, taps):
    return np.asarray(j_pad_stack(jnp.asarray(vol), len(taps) // 2, JBoundary.WRAP))


@pytest.fixture(scope="module")
def planes(vol):
    # planes wider than 256: no fractional bf16 coordinate past x = 128 and
    # no odd one past 256; at 40 rows one pyramid level, at 128 rows two
    return {"64x64": vol, "40x261": make_blob_volume(6, 40, 261, seed=5),
            "128x512": make_blob_volume(4, 128, 512, seed=6)}


@pytest.mark.parametrize("mode,plane", [("solve", "64x64"), ("compose", "64x64"),
                                        ("solve", "40x261"), ("solve", "128x512"),
                                        ("compose", "128x512")])
def test_pass_matches_tpu_oracle(planes, jc, mode, plane):
    taps = j_kernels((SIGMA,) * 3)[0]
    padded = _padded(planes[plane], taps)
    if mode == "solve":
        ref, cfg = jax_solve_pass(padded, taps, jc), jc
    else:
        cfg = dataclasses.replace(jc, tap_mode="compose", symmetric_adjacent=True)
        ref = jax_compose_pass(padded, taps, cfg)
    port = from_reference(cfg)
    out = of_pass_padded(torch.from_numpy(padded), taps, port).numpy()
    # XLA's CPU runtime flushes subnormals to zero (the blob stacks' tails
    # hold some); the port keeps them unless the thread flushes them too
    assert torch.set_flush_denormal(True)
    try:
        flushed = of_pass_padded(torch.from_numpy(padded), taps, port).numpy()
    finally:
        torch.set_flush_denormal(False)
    f32 = of_pass_padded(torch.from_numpy(padded), taps, from_reference(
        dataclasses.replace(cfg, dtype="float32"))).numpy()
    differ = out != ref
    print(f"bf16 {mode} pass with no bound on {plane} planes vs the TPU oracle: "
          f"{int(differ.sum())} of {out.size} values differ, the largest "
          f"{np.abs(out[differ]).max(initial=0):.3g} (all equal with subnormals "
          f"flushed: {np.array_equal(flushed, ref)}); the oracle vs the float32 "
          f"pass: {psnr(ref, f32):.2f} dB")
    np.testing.assert_array_equal(flushed, ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-35)


def test_zero_flow_in_the_pass_dtype(vol, jc):
    # the port seeds each run's first solve with zeros in the pass dtype, as
    # the JAX package does; a float32 zero flow (the bounded path's choice)
    # would run the coarsest level's first phase 1 in float32
    taps = j_kernels((SIGMA,) * 3)[0]
    padded = _padded(vol, taps)
    out = of_pass_padded(torch.from_numpy(padded), taps, from_reference(jc)).numpy()
    ref = jax_solve_pass(padded, taps, jc)
    f32_zero = jax_solve_pass(padded, taps, jc, zero_dtype=jnp.float32)
    value, other = psnr(out, ref), psnr(out, f32_zero)
    print(f"bf16 solve pass with no bound: PSNR {value:.2f} dB against the oracle "
          f"(bf16 zero flow), {other:.2f} dB against the oracle with a float32 "
          "zero flow")
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, f32_zero)


def test_denoise_matches_tpu_oracle(vol, jc):
    # three passes; the Y and X passes' 6 x 64 planes have no pyramid level
    out, kernels = np.asarray(vol, np.float32), j_kernels((SIGMA,) * 3)
    for (fwd, inv), taps in zip(VIEWS, kernels):
        passed = jax_solve_pass(_padded(np.transpose(out, fwd), taps), taps, jc)
        out = np.transpose(passed, inv)
    cfg = JFilterConfig(sigma=(SIGMA,) * 3, flow=jc)
    port = denoise(torch.from_numpy(vol), from_reference(cfg)).numpy()
    f32 = denoise(torch.from_numpy(vol), from_reference(dataclasses.replace(
        cfg, flow=dataclasses.replace(jc, dtype="float32")))).numpy()
    value, scale = psnr(port, out), psnr(out, f32)
    print(f"bf16 denoise with no bound vs the TPU oracle: PSNR {value:.2f} dB; "
          f"the oracle vs the float32 denoise: {scale:.2f} dB")
    np.testing.assert_array_equal(port, out)


@pytest.mark.parametrize("mode", ["solve", "compose"])
def test_slabs_equal_whole_axis(vol, mode):
    cfg = from_reference(JFilterConfig(sigma=(1.0,) * 3, flow=JFlowConfig(
        tap_mode=mode, **NOBOUND)))
    whole = denoise(torch.from_numpy(vol), cfg)
    slabbed = denoise(torch.from_numpy(vol), dataclasses.replace(cfg, slab_size=2))
    torch.testing.assert_close(slabbed, whole, atol=0, rtol=0)


@pytest.mark.parametrize("path", ["stream", "sharded", "batch"])
def test_other_paths_equal_in_memory(vol, tmp_path, path):
    # every path that reaches of_pass_padded runs the split route: the
    # stream's windows (a shifted tail), 3 CPU shards with their ring
    # halos, and a batch of two, each equal to the in-memory denoise
    cfg = from_reference(JFilterConfig(sigma=(1.0,) * 3, flow=JFlowConfig(**NOBOUND)))
    whole = denoise(torch.from_numpy(vol), cfg).numpy()
    if path == "stream":
        out = denoise_streamed(vol, cfg, slab_size=4, tmp_dir=str(tmp_path),
                               device="cpu")
    elif path == "sharded":
        out = denoise_sharded(vol, cfg, mesh=make_mesh(3, device="cpu")).numpy()
    else:
        outs = list(denoise_many([vol, vol[::-1].copy()], cfg, device="cpu"))
        np.testing.assert_array_equal(outs[1].numpy(), denoise(
            torch.from_numpy(vol[::-1].copy()), cfg).numpy())
        out = outs[0].numpy()
    np.testing.assert_array_equal(out, whole)


@pytest.mark.parametrize("flags", [
    [], ["--tap_flow", "compose", "--symmetric_adjacent", "--precision", "bfloat16"]],
    ids=["solve_bf16_nobound", "fast_nobound"])
def test_cli_runs(vol, tmp_path, flags):
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_mrc(src, vol)
    assert cli.main(["-i", str(src), "-o", str(dst), "--device", "cpu", "-s",
                     "0.5", "0.5", "0.5", "-l", "2", "--dtype", "bfloat16",
                     "--max_displacement", "0", *flags]) == 0
    out, _ = read_mrc(dst)
    assert out.shape == vol.shape and np.isfinite(out).all()


def test_slab_model_has_its_own_entry():
    nobound = from_reference(JFilterConfig(flow=JFlowConfig(**NOBOUND)))
    bounded = dataclasses.replace(nobound, flow=dataclasses.replace(
        nobound.flow, max_displacement=8))
    assert (memory.bytes_per_padded_voxel(nobound)
            == memory.BYTES_PER_PADDED_VOXEL["bfloat16_nobound"]
            != memory.bytes_per_padded_voxel(bounded))
    # the budget of a whole 256-plane 256^2 axis under the bounded model
    # slabs the no-bound pass, whose model is larger
    budget = memory.window_peak_bytes(bounded, 256, 256, 256, 8, None)
    assert memory.pass_slab(bounded, 256, 256, 256, 8, budget) is None
    slab = memory.pass_slab(nobound, 256, 256, 256, 8, budget)
    assert slab is not None and slab < 256
    assert memory.window_peak_bytes(nobound, 256, 256, 256, 8, slab) <= budget

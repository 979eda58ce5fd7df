"""K-compose-run-split on the CPU: the split route's compose pass
(``--tap_flow compose --dtype bfloat16 --max_displacement 0``).

The kernel (``csrc/compose.cu: compose_run_split_kernel``) cannot run here.
Its per-pixel loop is emulated below in float32 with every bf16 rounding
written out (bf16.cuh's split tap, ``tests/split_tap.py``), in its order:
the bf16 carry from zero in each run, F = bf16(F + sample(link, F)) with the
link's two channels at shared coordinates, acc = bf16(acc + bf16(sample(nb,
F) * w)), the backward run, then the forward run, and the backward links
read as -adj_fwd by a sign in symmetric mode.  It is
held bit for bit to the plain version ``compose_chain_plain`` (which
``tests/test_torch_bf16_nobound.py`` holds bit for bit to the JAX package's
TPU path through the pass) on the planes of that file, with symmetric and
separate links; on the card ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernel to it.
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from split_tap import BF16, rb, split_sample, split_tap

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.blur import rounded
from flowdenoising_tpu_torch.ops.compose import (
    compose_chain_plain, compose_run_plain, compose_run_split)

torch.set_num_threads(1)


def _step(link, nb, sign, u, v):
    """csrc/compose.cu: split_step for every pixel: (neighbour sample,
    new u, new v)."""
    tap = split_tap(u, v, True)
    su = split_sample(link[:, 0].float(), tap, True)
    sv = split_sample(link[:, 1].float(), tap, True)
    u, v = rb(u + sign * su), rb(v + sign * sv)
    return split_sample(nb.float(), split_tap(u, v, True), True), u, v


def emulated_compose_run_split(adj_fwd, adj_bwd, nb, acc, weights):
    """csrc/compose.cu: compose_run_split_kernel at every pixel."""
    ks2 = len(weights) // 2
    n = acc.shape[0]
    lb, sign = (adj_fwd, -1.0) if adj_bwd is None else (adj_bwd, 1.0)
    a = acc.float()
    ub = vb = uf = vf = torch.zeros(acc.shape)

    def bwd(j, u, v):
        return _step(lb[ks2 - j:ks2 - j + n], nb[ks2 - j:ks2 - j + n], sign, u, v)

    def fwd(j, u, v):
        return _step(adj_fwd[ks2 + j - 1:ks2 + j - 1 + n],
                     nb[ks2 + j:ks2 + j + n], 1.0, u, v)

    for j in range(1, ks2 + 1):
        s, ub, vb = bwd(j, ub, vb)
        a = rb(a + rb(s * weights[j - 1]))
    for j in range(1, ks2 + 1):
        s, uf, vf = fwd(j, uf, vf)
        a = rb(a + rb(s * weights[ks2 + j - 1]))
    return a.to(BF16)


# the planes of tests/test_torch_bf16_nobound.py
PLANES = {"64x64": (64, 64, 2), "40x261": (40, 261, 5), "128x512": (128, 512, 6)}


def _operands(plane, n, ks2, symmetric, scale=1.5):
    """A bf16 blob stack (n + 2*ks2 planes), bf16 links N(0, scale) with a
    band pushed 40 px past the right edge, the center tap of sigma ks2/4
    and the other taps' weights, rounded to bf16 as the pass rounds them."""
    h, w, seed = PLANES[plane]
    nb = torch.from_numpy(make_blob_volume(n + 2 * ks2, h, w, seed=seed)).to(BF16)
    r = np.random.default_rng(seed + ks2)

    def links():
        f = r.normal(size=(n + 2 * ks2 - 1, 2, h, w)) * scale
        f[:, 0, :, : w // 5] += 40
        return torch.from_numpy(f.astype(np.float32)).to(BF16)

    fwd = links()
    bwd = None if symmetric else links()
    taps = np.exp(-0.5 * (np.arange(-ks2, ks2 + 1) / (ks2 / 4)) ** 2)
    taps /= taps.sum()
    acc = nb[ks2:ks2 + n] * rounded(taps[ks2], BF16)
    weights = [rounded(taps[ks2 + s * j], BF16)
               for s in (-1, 1) for j in range(1, ks2 + 1)]
    return fwd, bwd, nb, acc, weights


@pytest.mark.parametrize("ks2", [2, 8, 12])
@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "two_links"])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_emulated_kernel_equals_plain(plane, symmetric, ks2):
    fwd, bwd, nb, acc, weights = _operands(plane, 2, ks2, symmetric)
    ref = compose_chain_plain(fwd, bwd, nb, acc.clone(), weights)
    assert ref.dtype == BF16
    got = emulated_compose_run_split(fwd, bwd, nb, acc, weights)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_large_links_leave_the_plane():
    # links of scale 600 push every carry far outside the plane: the floor
    # bound selects the edge pair, as in the plain version
    fwd, bwd, nb, acc, weights = _operands("40x261", 2, 4, False, scale=600.0)
    torch.testing.assert_close(
        emulated_compose_run_split(fwd, bwd, nb, acc, weights),
        compose_chain_plain(fwd, bwd, nb, acc.clone(), weights), atol=0, rtol=0)


def test_symmetric_sign_is_the_negated_copy():
    # the kernel reads adj_fwd with sign -1 in place of -adj_fwd
    fwd, _, nb, acc, weights = _operands("40x261", 3, 8, True)
    torch.testing.assert_close(
        compose_chain_plain(fwd, None, nb, acc.clone(), weights),
        compose_chain_plain(fwd, -fwd, nb, acc.clone(), weights), atol=0, rtol=0)
    torch.testing.assert_close(
        emulated_compose_run_split(fwd, None, nb, acc, weights),
        emulated_compose_run_split(fwd, -fwd, nb, acc, weights), atol=0, rtol=0)


def test_the_forward_terms_wait():
    # interleaving the two runs' additions rounds apart: the forward run's
    # terms must wait for the whole backward run, so a kernel that advanced
    # the runs side by side would have to hold them back
    fwd, bwd, nb, acc, weights = _operands("64x64", 4, 8, False)
    ks2 = 8
    lb, a = bwd, acc.float()
    ub = vb = uf = vf = torch.zeros(acc.shape)
    n = acc.shape[0]
    for j in range(1, ks2 + 1):
        sb, ub, vb = _step(lb[ks2 - j:ks2 - j + n], nb[ks2 - j:ks2 - j + n], 1.0, ub, vb)
        sf, uf, vf = _step(fwd[ks2 + j - 1:ks2 + j - 1 + n],
                           nb[ks2 + j:ks2 + j + n], 1.0, uf, vf)
        a = rb(a + rb(sb * weights[j - 1]))
        a = rb(a + rb(sf * weights[ks2 + j - 1]))
    assert not torch.equal(a.to(BF16),
                           compose_chain_plain(fwd, bwd, nb, acc.clone(), weights))


def test_chain_is_not_the_float32_pass():
    # the split route's chain rounds in bf16 where K-compose-run's plain
    # version (the bounded route) samples in float32
    fwd, bwd, nb, acc, weights = _operands("40x261", 2, 4, False)
    split = compose_chain_plain(fwd, bwd, nb, acc.clone(), weights)
    bounded = compose_run_plain(fwd, bwd, nb, acc.float(), weights, None, True)
    assert not torch.equal(split.float(), bounded)


def test_cpu_wrapper_counts_no_launch_and_refuses_bad_inputs():
    fwd, bwd, nb, acc, weights = _operands("64x64", 3, 2, False)
    before = dict(K.LAUNCHES)
    want = compose_chain_plain(fwd, bwd, nb, acc.clone(), weights)
    io = acc.clone()
    assert compose_run_split(fwd, bwd, nb, io, weights) is io
    torch.testing.assert_close(io, want, atol=0, rtol=0)
    assert K.LAUNCHES == before          # a CPU tensor: the plain version
    with pytest.raises(ValueError, match="weights"):
        compose_run_split(fwd, bwd, nb, acc, weights[:3])
    with pytest.raises(ValueError, match="expected"):
        compose_run_split(fwd, bwd, nb[1:], acc, weights)
    with pytest.raises(ValueError, match="expected"):
        compose_run_split(fwd[1:], bwd, nb, acc, weights)
    with pytest.raises(ValueError, match="expected"):
        compose_run_split(fwd, bwd[:, :1], nb, acc, weights)
    with pytest.raises(ValueError, match="expected"):
        compose_run_split(fwd, bwd, nb, acc[:, :4], weights)
    with pytest.raises(ValueError, match="no kernel"):
        compose_run_split(fwd.to("meta"), None, nb.to("meta"), acc.to("meta"),
                          weights)
    assert K.LAUNCHES == before

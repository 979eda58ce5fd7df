"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip on a host without a CUDA device (the kernels
have no CPU mode).  The file imports neither JAX nor the test suite's
conftest, so it runs on a machine with the card and no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the JAX package's own kernel bars: sampling atol 2e-4 on
data of scale ~50, Farneback iterations atol 5e-4 / rtol 1e-4, end to end
PSNR >= 55 dB.
"""

import numpy as np
import pytest
import torch

from flowdenoising_tpu_torch.config import FilterConfig
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate
from flowdenoising_tpu_torch.ops.warp import displace_sample, displace_sample_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("b,c,h,w,d", [
    (3, None, 64, 80, 8), (2, 5, 33, 47, 3), (4, None, 19, 130, None),
    (1, 1, 256, 256, 8),
])
def test_sample_kernel_matches_plain(dev, b, c, h, w, d):
    r = np.random.default_rng(b * h + w)
    shape = (b, h, w) if c is None else (b, c, h, w)
    src = _t(r.normal(size=shape) * 50, dev)
    # flow channels as views of a channel-first flow (batch stride 2*H*W)
    flow = r.normal(size=(b, 2, h, w)) * 3
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    before = K.LAUNCHES["sample"]
    out = displace_sample(src, flow[:, 0], flow[:, 1], d)
    assert K.LAUNCHES["sample"] == before + 1
    ref = displace_sample_plain(src, flow[:, 0], flow[:, 1], d)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("b,h,w,winsize,d", [
    (2, 64, 64, 5, 9), (3, 37, 70, 7, 3), (2, 8, 9, 5, 2), (2, 20, 22, 4, 3),
    (1, 48, 40, 15, 5), (2, 32, 32, 5, None), (1, 3, 3, 5, 2),
])
def test_umuf_kernel_matches_plain(dev, b, h, w, winsize, d):
    r = np.random.default_rng(h * w + winsize)
    rr = F.poly_expand(_t(r.normal(size=(2, b, h, w)) * 40, dev)).contiguous()
    flow = _t(r.normal(size=(b, 2, h, w)) * 2, dev)
    before = K.LAUNCHES["umuf"]
    out = umuf_iterate(rr[0], rr[1], flow, 3, d, winsize)
    assert K.LAUNCHES["umuf"] == before + 3
    ref = F.umuf_iterate_plain(rr[0], rr[1], flow, 3, d, winsize)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


def test_wrappers_refuse_what_they_do_not_take(dev):
    src = torch.zeros(2, 8, 8, device=dev)
    uv = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(ValueError):
        displace_sample(src.double(), uv, uv, 2)
    with pytest.raises(ValueError):
        displace_sample(src.transpose(1, 2), uv, uv, 2)
    r = torch.zeros(2, 5, 8, 8, device=dev)
    f = torch.zeros(2, 2, 8, 8, device=dev)
    with pytest.raises(ValueError):
        umuf_iterate(r, r, f.transpose(2, 3), 1, 2, 5)
    with pytest.raises(ValueError):
        umuf_iterate(r, r.cpu(), f, 1, 2, 5)


def test_denoise_card_matches_cpu(dev):
    r = np.random.default_rng(0)
    z = np.arange(12)[:, None, None]
    y = np.arange(40)[None, :, None]
    x = np.arange(36)[None, None, :]
    vol = (100 * np.sin(0.3 * (x + 0.5 * z)) * np.cos(0.25 * (y - 0.3 * z))
           + r.normal(0, 10, (12, 40, 36))).astype(np.float32)
    on_card = denoise(torch.from_numpy(vol).to(dev), FilterConfig()).cpu().numpy()
    on_cpu = denoise(torch.from_numpy(vol), FilterConfig()).numpy()
    mse = np.mean((on_card.astype(np.float64) - on_cpu) ** 2)
    peak = on_cpu.max() - on_cpu.min()
    assert 10 * np.log10(peak * peak / max(mse, 1e-30)) >= 55

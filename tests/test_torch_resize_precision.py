"""The resize products run in full float32 whatever matmul precision the
process has set, as the JAX package pins its resize einsums to HIGHEST
(``flowdenoising_tpu/ops/resize.py: _apply_separable``).

On the CPU, ``torch.set_float32_matmul_precision("medium")`` sends float32
products through oneDNN in bfloat16, and ``torch.backends.fp32_precision``
or ``torch.backends.mkldnn.matmul.fp32_precision`` reach the same route,
and unpinned they move the resize.  Each case must give the bits of the
"highest" setting and leave the caller's setting as it found it.
"""

import warnings

import numpy as np
import pytest
import torch

from flowdenoising_tpu_torch.ops.resize import resize_area, resize_linear

torch.set_num_threads(1)

RESIZES = [(resize_linear, (128, 128)), (resize_area, (64, 64))]


def _settings():
    """Every float32 precision setting the products can read."""
    return (torch.backends.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


def _reset():
    """The process's default: "highest", every backend setting "none"."""
    torch.set_float32_matmul_precision("highest")
    for backend in (torch.backends, torch.backends.cuda.matmul,
                    torch.backends.mkldnn, torch.backends.mkldnn.matmul):
        backend.fp32_precision = "none"


@pytest.fixture
def restore_precision():
    _reset()
    assert torch.get_float32_matmul_precision() == "highest"
    yield
    _reset()


@pytest.fixture(scope="module")
def img():
    r = np.random.default_rng(0)
    return torch.from_numpy((r.normal(size=(4, 2, 256, 256)) * 3).astype(np.float32))


@pytest.mark.parametrize("resize,out_hw", RESIZES, ids=["linear", "area"])
@pytest.mark.parametrize("precision", ["medium", "high"])
def test_legacy_precision_does_not_reach_the_resize(img, resize, out_hw,
                                                    precision,
                                                    restore_precision):
    ref = resize(img, out_hw)
    torch.set_float32_matmul_precision(precision)
    before = _settings()
    out = resize(img, out_hw)
    assert torch.get_float32_matmul_precision() == precision
    assert _settings() == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("resize,out_hw", RESIZES, ids=["linear", "area"])
@pytest.mark.parametrize("route", ["generic", "mkldnn.matmul"])
def test_backend_precision_does_not_reach_the_resize(img, resize, out_hw,
                                                     route, restore_precision):
    ref = resize(img, out_hw)
    wr = torch.from_numpy(np.random.default_rng(1).random((128, 256),
                                                          np.float32))
    product = wr @ img[0, 0]
    if route == "generic":
        torch.backends.fp32_precision = "bf16"
    else:
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    before = _settings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # unpinned, this setting moves a float32 product: the case tests a
        # route that reaches the einsum
        assert not torch.equal(wr @ img[0, 0], product)
        out = resize(img, out_hw)
    assert _settings() == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)

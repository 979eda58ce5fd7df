"""The port's throughput mode ``denoise_many`` on the CPU (the counterpart
of ``tests/test_batch.py``): equal to single ``denoise`` calls at atol 0,
a lazily consumed generator, a caller's tensor never written, ``to_host``,
the window's backpressure (at most ``window`` volumes staged or in flight),
an error of the staging thread raised in the caller, and the refusal to
run on CUDA without a card.
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core import pipeline
from flowdenoising_tpu_torch.core.pipeline import denoise, denoise_many

torch.set_num_threads(1)

CFG = FilterConfig(sigma=(0.5, 1.0, 0.5), boundary=Boundary.WRAP,
                   flow=FlowConfig(levels=1, winsize=5, max_displacement=4))


def _vols(n, seed=31):
    return [make_blob_volume(6, 24, 20, seed=seed + s) for s in range(n)]


def test_denoise_many_equals_singles():
    vols = _vols(3)
    batch = denoise_many(vols, CFG, device="cpu")
    assert len(batch) == 3
    for v, out in zip(vols, batch):
        assert isinstance(out, torch.Tensor)
        torch.testing.assert_close(out, denoise(v, CFG, device="cpu"),
                                   atol=0, rtol=0)


def test_generator_is_consumed_lazily(monkeypatch):
    vols = _vols(4, seed=41)
    pulled, dispatched = [], []
    real = pipeline.denoise

    def gen():
        for i, v in enumerate(vols):
            pulled.append((i, len(dispatched)))
            yield v.copy()

    def spy(v, cfg, **kw):
        dispatched.append(1)
        return real(v, cfg, **kw)

    monkeypatch.setattr(pipeline, "denoise", spy)
    batch = denoise_many(gen(), CFG, window=2, device="cpu")
    monkeypatch.undo()
    # the first two staged before any dispatch, each later one only after
    # a dispatch made room
    assert [i for i, _ in pulled] == [0, 1, 2, 3]
    assert [d for _, d in pulled] == [0, 0, 2, 3]
    for v, out in zip(vols, batch):
        torch.testing.assert_close(out, denoise(v, CFG, device="cpu"),
                                   atol=0, rtol=0)


def test_callers_tensor_is_not_written():
    host = _vols(1, seed=7)[0]
    held = torch.from_numpy(host.copy())
    out = denoise_many([held, host], CFG, device="cpu")
    np.testing.assert_array_equal(held.numpy(), host)
    torch.testing.assert_close(out[0], out[1], atol=0, rtol=0)


def test_to_host_returns_arrays():
    vols = _vols(3, seed=51)
    batch = denoise_many(iter(vols), CFG, window=1, to_host=True, device="cpu")
    for v, out in zip(vols, batch):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, denoise(v, CFG, device="cpu").numpy())


@pytest.mark.parametrize("window", [1, 2, 3])
def test_backpressure_bounds_staged_and_in_flight(monkeypatch, window):
    """Volumes pulled from the iterable (staged) and not yet waited for
    stay at most ``window`` at every step."""
    events = []
    real_denoise, real_wait = pipeline.denoise, pipeline._wait_done

    def gen():
        for v in _vols(6, seed=60):
            events.append("stage")
            yield v

    def spy_denoise(v, cfg, **kw):
        events.append("dispatch")
        return real_denoise(v, cfg, **kw)

    def spy_wait(done):
        events.append("done")
        real_wait(done)

    monkeypatch.setattr(pipeline, "denoise", spy_denoise)
    monkeypatch.setattr(pipeline, "_wait_done", spy_wait)
    out = denoise_many(gen(), CFG, window=window, device="cpu")
    assert len(out) == 6
    held, most = 0, 0
    for e in events:
        held += {"stage": 1, "dispatch": 0, "done": -1}[e]
        most = max(most, held)
    assert events.count("done") == 6
    assert most == min(window, 6)


def test_staging_error_is_raised_in_the_caller():
    with pytest.raises(TypeError, match="can't convert"):
        denoise_many([_vols(1)[0], np.array(["not", "a", "volume"])], CFG,
                     device="cpu")


def test_default_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a host without it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        denoise_many(_vols(1), CFG)

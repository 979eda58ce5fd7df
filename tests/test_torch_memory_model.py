"""The slab memory model (``core/memory.py``) on the CPU: the auto slab is
the whole axis at 256^3 and 512^3 (and at the tomogram size) at the H100's
budget, slabs are balanced and never above the model, the floor holds, D
does not move the slab, every peak measured on the card lies at or under
the model, and an in-memory denoise split by a small budget equals the
whole axis bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.pipeline import denoise

torch.set_num_threads(1)

GIB = 2 ** 30
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# what a pass may plan for on that card: HEADROOM of the ~78 GiB free
# after the CUDA context
H100_BUDGET = int(memory.HEADROOM * 78 * GIB)
KS2 = (8, 8, 8)   # sigma 2

FORMS = {
    "gaussian": None,
    "solve": {},
    "solve_d48": {"max_displacement": 48},
    "solve_unbounded": {"max_displacement": None},
    "presmooth": {"presmooth": 1.5},
    "compose": {"tap_mode": "compose"},
    "compose_symmetric": {"tap_mode": "compose", "symmetric_adjacent": True},
    "solve_bf16": {"dtype": "bfloat16", "precision": "bfloat16"},
    "solve_precision_bf16": {"precision": "bfloat16"},
    "solve_dtype_bf16": {"dtype": "bfloat16"},
    "compose_bf16": {"tap_mode": "compose", "dtype": "bfloat16",
                     "precision": "bfloat16"},
    "fast": {"tap_mode": "compose", "symmetric_adjacent": True,
             "dtype": "bfloat16", "precision": "bfloat16"},
}
# the bf16 pass with no bound (the split route), its own entry of the model
NOBOUND_FORMS = {
    "solve_bf16_nobound": {"dtype": "bfloat16", "max_displacement": None},
    "fast_nobound": {"tap_mode": "compose", "symmetric_adjacent": True,
                     "dtype": "bfloat16", "precision": "bfloat16",
                     "max_displacement": None},
}


def _cfg(form):
    fields = {**FORMS, **NOBOUND_FORMS}[form]
    if fields is None:
        return FilterConfig(use_flow=False)
    return FilterConfig(flow=FlowConfig(**fields))


# One pass over a padded window of n + 16 planes of h x w (sigma 2), the
# window made on the card just before: peak of max_memory_allocated above
# what was allocated before it, in bytes.  CARD, scripts/torch_memory_peaks.py.
PASS_PEAKS = [
    ("gaussian", 64, 256, 256, 71303168),
    ("solve", 64, 256, 256, 480837632),
    ("solve_d48", 64, 256, 256, 447283200),
    ("solve_unbounded", 64, 256, 256, 447283200),
    ("presmooth", 64, 256, 256, 468254720),
    ("compose", 64, 256, 256, 447283200),
    ("compose_symmetric", 64, 256, 256, 447283200),
    ("solve_bf16", 64, 256, 256, 394657792),
    ("solve_precision_bf16", 64, 256, 256, 447283200),
    ("solve_dtype_bf16", 64, 256, 256, 465305600),
    ("compose_bf16", 64, 256, 256, 388034560),
    ("fast", 64, 256, 256, 367063040),
    ("gaussian", 256, 256, 256, 272629760),
    ("solve", 256, 256, 256, 1520762880),
    ("solve_d48", 256, 256, 256, 1520762880),
    ("solve_unbounded", 256, 256, 256, 1520762880),
    ("presmooth", 256, 256, 256, 1592066048),
    ("compose", 256, 256, 256, 1520762880),
    ("compose_symmetric", 256, 256, 256, 1520762880),
    ("solve_bf16", 256, 256, 256, 1500971008),
    ("solve_precision_bf16", 256, 256, 256, 1520762880),
    ("solve_dtype_bf16", 256, 256, 256, 1735983104),
    ("compose_bf16", 256, 256, 256, 1320132608),
    ("fast", 256, 256, 256, 1248829440),
    ("gaussian", 32, 512, 512, 150994944),
    ("solve", 32, 512, 512, 1073479680),
    ("solve_d48", 32, 512, 512, 1073479680),
    ("solve_unbounded", 32, 512, 512, 1073479680),
    ("presmooth", 32, 512, 512, 1123811328),
    ("compose", 32, 512, 512, 1073479680),
    ("compose_symmetric", 32, 512, 512, 1073479680),
    ("solve_bf16", 32, 512, 512, 834535424),
    ("solve_precision_bf16", 32, 512, 512, 1073479680),
    ("solve_dtype_bf16", 32, 512, 512, 1001652224),
    ("compose_bf16", 32, 512, 512, 916963328),
    ("fast", 32, 512, 512, 866631680),
    ("gaussian", 128, 512, 512, 553648128),
    ("solve", 128, 512, 512, 3220439040),
    ("solve_d48", 128, 512, 512, 3220439040),
    ("solve_unbounded", 128, 512, 512, 3220439040),
    ("presmooth", 128, 512, 512, 3371433984),
    ("compose", 128, 512, 512, 3220439040),
    ("compose_symmetric", 128, 512, 512, 3220439040),
    ("solve_bf16", 128, 512, 512, 3045195776),
    ("solve_precision_bf16", 128, 512, 512, 3220439040),
    ("solve_dtype_bf16", 128, 512, 512, 3547201536),
    ("compose_bf16", 128, 512, 512, 2775302144),
    ("fast", 128, 512, 512, 2624307200),
    ("gaussian", 16, 1024, 1024, 335544320),
    ("solve", 16, 1024, 1024, 2862612480),
    ("solve_d48", 16, 1024, 1024, 2862612480),
    ("solve_unbounded", 16, 1024, 1024, 2862612480),
    ("presmooth", 16, 1024, 1024, 2996830208),
    ("compose", 16, 1024, 1024, 2862612480),
    ("compose_symmetric", 16, 1024, 1024, 2862612480),
    ("solve_bf16", 16, 1024, 1024, 1864368128),
    ("solve_precision_bf16", 16, 1024, 1024, 2862612480),
    ("solve_dtype_bf16", 16, 1024, 1024, 2310012928),
    ("compose_bf16", 16, 1024, 1024, 2421620736),
    ("fast", 16, 1024, 1024, 2291597312),
    ("gaussian", 64, 1024, 1024, 1140850688),
    ("solve", 64, 1024, 1024, 7156531200),
    ("solve_d48", 64, 1024, 1024, 7156531200),
    ("solve_unbounded", 64, 1024, 1024, 7156531200),
    ("presmooth", 64, 1024, 1024, 7492075520),
    ("compose", 64, 1024, 1024, 7156531200),
    ("compose_symmetric", 64, 1024, 1024, 7156531200),
    ("solve_bf16", 64, 1024, 1024, 6285688832),
    ("solve_precision_bf16", 64, 1024, 1024, 7156531200),
    ("solve_dtype_bf16", 64, 1024, 1024, 7399800832),
    ("compose_bf16", 64, 1024, 1024, 6138298368),
    ("fast", 64, 1024, 1024, 5806948352),
    ("gaussian", 64, 128, 1024, 142606336),
    ("solve", 64, 128, 1024, 893911040),
    ("solve_d48", 64, 128, 1024, 893911040),
    ("solve_unbounded", 64, 128, 1024, 893911040),
    ("presmooth", 64, 128, 1024, 935854080),
    ("compose", 64, 128, 1024, 893911040),
    ("compose_symmetric", 64, 128, 1024, 893911040),
    ("solve_bf16", 64, 128, 1024, 781451264),
    ("solve_precision_bf16", 64, 128, 1024, 893911040),
    ("solve_dtype_bf16", 64, 128, 1024, 919076864),
    ("compose_bf16", 64, 128, 1024, 767131648),
    ("fast", 64, 128, 1024, 725188608),
    ("gaussian", 64, 1024, 128, 142606336),
    ("solve", 64, 1024, 128, 893911040),
    ("solve_d48", 64, 1024, 128, 893911040),
    ("solve_unbounded", 64, 1024, 128, 893911040),
    ("presmooth", 64, 1024, 128, 935854080),
    ("compose", 64, 1024, 128, 893911040),
    ("compose_symmetric", 64, 1024, 128, 893911040),
    ("solve_bf16", 64, 1024, 128, 781451264),
    ("solve_precision_bf16", 64, 1024, 128, 893911040),
    ("solve_dtype_bf16", 64, 1024, 128, 919076864),
    ("compose_bf16", 64, 1024, 128, 767131648),
    ("fast", 64, 1024, 128, 725188608),
    ("solve_bf16_nobound", 64, 256, 256, 512132096),
    ("fast_nobound", 64, 256, 256, 492569600),
    ("solve_bf16_nobound", 256, 256, 256, 1853654016),
    ("fast_nobound", 256, 256, 256, 1927021568),
    ("solve_bf16_nobound", 32, 512, 512, 997591040),
    ("fast_nobound", 32, 512, 512, 1013975040),
    ("solve_bf16_nobound", 128, 512, 512, 3747743744),
    ("fast_nobound", 128, 512, 512, 3882878976),
    ("solve_bf16_nobound", 16, 1024, 1024, 2156924928),
    ("fast_nobound", 16, 1024, 1024, 2139099136),
    ("solve_bf16_nobound", 64, 1024, 1024, 7657230336),
    ("fast_nobound", 64, 1024, 1024, 7876907008),
    ("solve_bf16_nobound", 64, 128, 1024, 955517440),
    ("fast_nobound", 64, 128, 1024, 985139712),
    ("solve_bf16_nobound", 64, 1024, 128, 955517440),
    ("fast_nobound", 64, 1024, 128, 985139712),
]


# In-memory denoises, the input tensor held by the caller (solve, sigma 2,
# D 8): peak device memory in GiB as chip_smoke.py printed it (3 decimals).
# CARD.
DENOISE_PEAKS = [
    ((256, 256, 256), 1.510),
    ((512, 512, 512), 11.529),
    ((384, 512, 512), 8.738),
    ((128, 1024, 1024), 12.528),
]


@pytest.mark.parametrize("form,n,h,w,peak", PASS_PEAKS)
def test_measured_pass_peaks_are_under_the_model(form, n, h, w, peak):
    assert peak <= memory.pass_bytes(_cfg(form), n + 16, h, w)


@pytest.mark.parametrize("shape,peak_gib", DENOISE_PEAKS)
def test_measured_denoise_peaks_are_under_the_model(shape, peak_gib):
    model = memory.denoise_peak_bytes(_cfg("solve"), shape, KS2)
    assert (peak_gib + 0.0005) * GIB <= model
    # the model stays within 10% of what was measured
    assert model <= 1.1 * peak_gib * GIB


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 512, 512),
                                   (512, 1024, 1024)])
@pytest.mark.parametrize("streamed", [False, True])
def test_whole_axis_at_the_cards_budget(form, shape, streamed):
    z, y, x = shape
    for n, h, w in ((z, y, x), (y, z, x), (x, z, y)):
        assert memory.pass_slab(_cfg(form), n, h, w, 8, H100_BUDGET,
                                streamed) is None


@pytest.mark.parametrize("form", sorted(NOBOUND_FORMS))
@pytest.mark.parametrize("streamed", [False, True])
def test_nobound_slabs_at_the_cards_budget(form, streamed):
    # its own entry: the whole axis at 256^3 and 512^3; the tomogram's
    # 512 x 1024 x 1024 Z pass whole in memory, and in slabs when streamed
    # (the next window and the last output beside the pass), each window
    # under the budget
    cfg = _cfg(form)
    for n in (256, 512):
        assert memory.pass_slab(cfg, n, n, n, 8, H100_BUDGET, streamed) is None
    slab = memory.pass_slab(cfg, 512, 1024, 1024, 8, H100_BUDGET, streamed)
    assert (slab is not None and slab < 512) == streamed
    assert memory.window_peak_bytes(cfg, 512, 1024, 1024, 8, slab,
                                    streamed) <= H100_BUDGET


@pytest.mark.parametrize("streamed", [False, True])
def test_slabs_balanced_and_never_above_the_model(streamed):
    cfg = _cfg("solve")
    n, h, w, ks2 = 1024, 1024, 1024, 8
    whole = memory.window_peak_bytes(cfg, n, h, w, ks2, None, streamed)
    for frac in np.linspace(0.05, 0.99, 40):
        budget = int(frac * whole)
        slab = memory.pass_slab(cfg, n, h, w, ks2, budget, streamed)
        assert slab is not None and slab <= n
        if slab > memory.SLAB_FLOOR:
            assert memory.window_peak_bytes(cfg, n, h, w, ks2, slab,
                                            streamed) <= budget
            # balanced: the smallest slab of its window count; and no
            # fewer windows fit (the slab one window fewer needs breaks
            # the budget)
            n_win = -(-n // slab)
            assert slab == -(-n // n_win)
            if n_win > 1:
                assert memory.window_peak_bytes(
                    cfg, n, h, w, ks2, -(-n // (n_win - 1)), streamed) > budget


def test_floor_holds():
    cfg = _cfg("solve")
    assert memory.pass_slab(cfg, 300, 1024, 1024, 8, 1) == memory.SLAB_FLOOR
    # a floor slab is still balanced over the axis
    assert memory.pass_slab(cfg, 20, 1024, 1024, 8, 1) == 7


def test_explicit_slab_size_wins():
    cfg = dataclasses.replace(_cfg("solve"), slab_size=13)
    assert memory.pass_slab(cfg, 256, 256, 256, 8, 1) == 13
    assert memory.pass_slab(cfg, 256, 256, 256, 8, None) == 13


def test_no_budget_is_the_whole_axis():
    assert memory.pass_slab(_cfg("solve"), 4096, 4096, 4096, 8, None) is None
    assert memory.device_budget("cpu") is None


@pytest.mark.parametrize("d", [8, 24, 48, None])
def test_slab_does_not_move_with_d(d):
    # measured on the card: the peaks at D 8, 48 and no bound are equal
    # (PASS_PEAKS), so the model, unlike the JAX package's TPU one, does
    # not shrink the slab as D grows
    base = _cfg("solve")
    cfg = dataclasses.replace(base, flow=dataclasses.replace(
        base.flow, max_displacement=d))
    budget = 20 * GIB
    assert memory.pass_slab(cfg, 1024, 1024, 1024, 8, budget) == \
        memory.pass_slab(base, 1024, 1024, 1024, 8, budget)
    for form, n, h, w, peak in PASS_PEAKS:
        if form in ("solve_d48", "solve_unbounded"):
            assert peak <= memory.pass_bytes(cfg, n + 16, h, w)


def test_forms_order():
    # the bf16 pass dtype holds the most, presmooth adds its blurred copy,
    # the no-flow Gaussian the least
    b = {f: memory.bytes_per_padded_voxel(_cfg(f)) for f in FORMS}
    assert b["gaussian"] < b["solve"] == b["compose"] == b["solve_precision_bf16"]
    assert b["solve"] < b["presmooth"] and b["solve"] < b["solve_dtype_bf16"]
    # with no bound the bf16 pass gathers its tap warps and compose chain
    # in plain PyTorch, with int64 indices: the most of all
    for form in NOBOUND_FORMS:
        assert memory.bytes_per_padded_voxel(_cfg(form)) > max(b.values())


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN])
def test_auto_slabs_equal_the_whole_axis(monkeypatch, boundary):
    vol = make_blob_volume(12, 24, 20, seed=8)
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), boundary=boundary,
                       flow=FlowConfig(levels=1, winsize=5, max_displacement=4))
    whole = denoise(vol, cfg, device="cpu")
    passes = [(12, 24, 20), (24, 12, 20), (20, 12, 24)]
    # at this size the floor would hold every slab at 8 planes
    monkeypatch.setattr(memory, "SLAB_FLOOR", 1)
    budget = min(memory.window_peak_bytes(cfg, n, h, w, 4, n // 3)
                 for n, h, w in passes)
    slabs = [memory.pass_slab(cfg, n, h, w, 4, budget) for n, h, w in passes]
    assert all(-(-n // s) >= 3 for (n, _, _), s in zip(passes, slabs))
    windows = []
    real = memory.pass_slab

    def spy(*a, **k):
        windows.append(real(*a, **k))
        return windows[-1]

    monkeypatch.setattr(memory, "device_budget", lambda device: budget)
    monkeypatch.setattr(memory, "pass_slab", spy)
    out = denoise(vol, cfg, device="cpu")
    assert windows == slabs
    torch.testing.assert_close(out, whole, atol=0, rtol=0)

"""The JAX package's public API in the port, on the CPU.

- Names: every name in every ``__all__`` of ``flowdenoising_tpu`` and its
  subpackages imports from the port's module of the same name.
- Signatures: each of those functions, and each function the port took on
  with them, has every JAX parameter by name, in order and with the same
  default; the port adds only ``device`` (where an input that is not a
  tensor goes).  The ``parallel`` names keep the port's own signatures: a
  mesh there is a list of ``torch.device``s, not a ``jax`` mesh.
- The AST walk: every public top-level function and class of every JAX
  module outside ``ops/pallas/`` has a counterpart in the port's module of
  the same path, or stands in ``NOT_PORTED`` with its reason.
- The repairs: ``warp_slices`` on an (H, W) plane, on (2, 3, H, W) and on
  NumPy inputs, and ``farneback_flow`` on NumPy inputs, each against the
  JAX package's within the bars of tests/test_torch_sample.py (sampling
  atol 2e-4) and tests/test_torch_farneback.py (flow max 1e-3 px, mean
  1e-5 px).
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flowdenoising_tpu as J
from conftest import make_blob_image
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops.farneback import farneback_flow as j_farneback_flow
from flowdenoising_tpu.ops.warp import warp_slices as j_warp_slices

import flowdenoising_tpu_torch as T
from flowdenoising_tpu_torch.config import from_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", ".ops", ".core", ".utils", ".parallel", ".io"]
ALL_NAMES = [(sub, name) for sub in SUBPACKAGES
             for name in importlib.import_module(J.__name__ + sub).__all__]

# JAX names whose signatures are the port's own, with the reason
OWN_SIGNATURES = {
    ".parallel": "a mesh is a list of torch.devices, not a jax mesh; the "
                 "halo exchange moves whole shard blocks, not a shard_map slice",
}
# functions the port took on in this API, by module path: (name, JAX module)
TAKEN_ON = [
    ("flowdenoising_tpu_torch.core.axis_filter", "gaussian_pass"),
    ("flowdenoising_tpu_torch.core.axis_filter", "of_pass"),
    ("flowdenoising_tpu_torch.core.pipeline", "pass_slab"),
    ("flowdenoising_tpu_torch.ops.blur", "box_blur"),
    ("flowdenoising_tpu_torch.ops.warp", "bilinear_displace_windowed"),
    ("flowdenoising_tpu_torch.ops.warp", "displace_sample"),
    ("flowdenoising_tpu_torch.ops.farneback", "prepped_tap_solver"),
    ("flowdenoising_tpu_torch.ops.farneback", "matmul_precision"),
    ("flowdenoising_tpu_torch.utils.metrics", "psnr"),
    ("flowdenoising_tpu_torch.utils.metrics", "ssim"),
    ("flowdenoising_tpu_torch.utils.metrics", "ssim_slice"),
    ("flowdenoising_tpu_torch.utils.tracing", "device_trace"),
    ("flowdenoising_tpu_torch.utils.tracing", "annotate"),
]
# public JAX functions with no counterpart in the port, with the reason
NOT_PORTED = {
    "core/autodisp.py": {
        "expected_probe_shapes": "XLA compile helper: the shapes the probe "
                                 "programs are compiled for ahead of a run",
        "seed_probe_cache": "XLA compile helper: seeds the persistent "
                            "compilation cache with the probe programs",
        "warm_probe_programs_async": "XLA compile helper: compiles the probe "
                                     "programs on a background thread",
    },
    "utils/compile_cache.py": {
        "enable_compilation_cache": "XLA's persistent compilation cache; "
                                    "the port compiles no programs",
    },
}


def _port_module(jax_module: str):
    return importlib.import_module(
        jax_module.replace("flowdenoising_tpu", "flowdenoising_tpu_torch", 1))


@pytest.mark.parametrize("sub,name", ALL_NAMES,
                         ids=[f"{s or 'top'}:{n}" for s, n in ALL_NAMES])
def test_all_names_import_from_the_port(sub, name):
    port = importlib.import_module(T.__name__ + sub)
    assert name in port.__all__, f"{name} not in the port's {sub or 'top'} __all__"
    obj = getattr(port, name)
    jax_obj = getattr(importlib.import_module(J.__name__ + sub), name)
    if callable(jax_obj):
        assert callable(obj)


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


def _check_signature(jax_fn, port_fn):
    jax_p = _params(jax_fn)
    port_p = [(n, d) for n, d in _params(port_fn) if n != "device"]
    assert [n for n, _ in port_p] == [n for n, _ in jax_p], (jax_p, port_p)
    for (name, jd), (_, td) in zip(jax_p, port_p):
        assert repr(jd) == repr(td), f"{name}: default {td!r}, JAX {jd!r}"
    names = [n for n, _ in _params(port_fn)]
    if "device" in names:
        assert names[-1] == "device", names


SIGNATURE_CASES = (
    [(J.__name__ + sub, name) for sub, name in ALL_NAMES
     if sub not in OWN_SIGNATURES
     and inspect.isfunction(getattr(importlib.import_module(J.__name__ + sub),
                                    name))]
    + [(m.replace("flowdenoising_tpu_torch", "flowdenoising_tpu", 1), n)
       for m, n in TAKEN_ON])


@pytest.mark.parametrize("module,name", SIGNATURE_CASES,
                         ids=[f"{m}:{n}" for m, n in SIGNATURE_CASES])
def test_signatures_carry_the_jax_parameters(module, name):
    jax_fn = getattr(importlib.import_module(module), name)
    port_fn = getattr(_port_module(jax_fn.__module__), name)
    _check_signature(jax_fn, port_fn)


def test_own_signatures_are_only_the_parallel_names():
    own = [n for s, n in ALL_NAMES if s in OWN_SIGNATURES]
    assert sorted(own) == ["denoise_sharded", "halo_exchange", "make_mesh"]


def _public_defs(path: Path) -> list[str]:
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined_names(path: Path) -> set[str]:
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return names


JAX_MODULES = sorted(
    str(p.relative_to(REPO / "flowdenoising_tpu"))
    for p in (REPO / "flowdenoising_tpu").rglob("*.py")
    if p.relative_to(REPO / "flowdenoising_tpu").parts[:2] != ("ops", "pallas"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_function_has_a_counterpart(rel):
    names = _public_defs(REPO / "flowdenoising_tpu" / rel)
    skipped = NOT_PORTED.get(rel, {})
    assert set(skipped) <= set(names), "NOT_PORTED names what is not there"
    port = REPO / "flowdenoising_tpu_torch" / rel
    wanted = [n for n in names if n not in skipped]
    if not wanted:
        return
    assert port.exists(), f"no {port.relative_to(REPO)} for {wanted}"
    missing = [n for n in wanted if n not in _defined_names(port)]
    assert not missing, f"{rel}: no counterpart in the port for {missing}"
    # the module's counterparts are importable objects, not just names
    mod = _port_module("flowdenoising_tpu." + rel[:-3].replace("/", "."))
    for n in wanted:
        assert hasattr(mod, n), n


def test_not_ported_has_no_counterpart():
    # the exception list stays the list of what the port lacks
    for rel, names in NOT_PORTED.items():
        port = REPO / "flowdenoising_tpu_torch" / rel
        have = _defined_names(port) if port.exists() else set()
        assert not set(names) & have, (rel, set(names) & have)


# -- the repairs: warp_slices and farneback_flow take what JAX's take --------

ATOL = 2e-4


def _warp_case(shape, seed):
    """Planes of a blob image (values up to ~200) and flows N(0, 2).

    The data is smooth because the port, like cv2.remap and the JAX
    package's exact gather, forms the coordinate x + u in float32 before
    it takes the fraction, whose error is then ulp(x) times the step
    between neighbouring texels; the JAX package's windowed form weighs
    |u - s| and has no such error.  On white noise of scale 50 at x ~ 40
    the two differ by up to ~3e-4 at D 3, on images by far less.
    """
    r = np.random.default_rng(seed)
    n = int(np.prod(shape[:-2]))
    h, w = shape[-2:]
    base = make_blob_image(h + n, w + n, seed=seed)
    ref = np.stack([base[i:i + h, i:i + w] for i in range(n)]).reshape(shape)
    flow = (r.normal(size=shape + (2,)) * 2).astype(np.float32)
    return np.ascontiguousarray(ref, np.float32), flow


@pytest.mark.parametrize("shape", [(40, 40), (2, 3, 40, 40)],
                         ids=["plane", "2x3_stack"])
@pytest.mark.parametrize("max_displacement", [None, 3])
def test_warp_slices_any_leading_dims(shape, max_displacement):
    ref, flow = _warp_case(shape, seed=len(shape))
    want = np.asarray(j_warp_slices(jnp.asarray(ref), jnp.asarray(flow),
                                    max_displacement))
    out = T.warp_slices(torch.from_numpy(ref), torch.from_numpy(flow),
                        max_displacement)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)


def test_warp_slices_numpy_inputs():
    ref, flow = _warp_case((2, 40, 40), seed=5)
    want = np.asarray(j_warp_slices(jnp.asarray(ref), jnp.asarray(flow)))
    out = T.warp_slices(ref, flow, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)


def test_farneback_flow_numpy_inputs():
    base = make_blob_image(40, 40, seed=6)
    ref = base[4:44, 4:44][None].copy()
    tgt = base[5:45, 2:42][None].copy()
    jc = JFlowConfig()
    want = np.asarray(j_farneback_flow(ref, tgt, jc))
    out = T.farneback_flow(ref, tgt, from_reference(jc), device="cpu")
    assert out.shape == (1, 40, 40, 2) and out.device.type == "cpu"
    err = np.abs(out.numpy() - want)
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-5, err.mean()


def test_arrays_go_to_the_tensors_device():
    # a NumPy input beside a tensor runs on the tensor's device, whatever
    # ``device`` says
    ref, flow = _warp_case((2, 24, 24), seed=7)
    out = T.warp_slices(torch.from_numpy(ref), flow, 2)
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(
        out.numpy(), T.warp_slices(ref, flow, 2, device="cpu").numpy())


def test_array_inputs_default_to_cuda():
    # an array goes to CUDA unless the caller asks for the CPU; with no
    # CUDA device that raises instead of running on the CPU
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a host without it")
    from flowdenoising_tpu_torch.core import gaussian_pass
    from flowdenoising_tpu_torch.ops import box_blur
    from flowdenoising_tpu_torch.utils.metrics import psnr
    ref, flow = _warp_case((2, 24, 24), seed=8)
    taps = np.array([0.25, 0.5, 0.25])
    for call in (lambda: T.warp_slices(ref, flow),
                 lambda: T.farneback_flow(ref, ref),
                 lambda: gaussian_pass(ref, taps),
                 lambda: box_blur(ref, 5),
                 lambda: psnr(ref, ref)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()

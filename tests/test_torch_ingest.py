"""The port's serve ingest (deep_vision_tpu_torch/ops/ingest.py and
ops/preprocess.py) against the JAX reference: the Pallas ``serve_ingest``
in interpret mode, and the XLA ``serve_normalize`` +
``quantize_activations`` prologue.

On the CPU the wrapper computes the plain PyTorch version; the CUDA
kernel is held against that same plain version on the card by
``chip_smoke.py``; the kernel looks each byte up in a table of the
plain arithmetic's outputs, so the plain version is held against the
JAX reference on every byte value of every channel here.  Tolerances:
int8 codes must agree exactly (the reference's own gate allows one
quantization step, which is asserted
too); float32 outputs within atol 1e-6, since XLA on the CPU may turn
the division by 255 into a reciprocal multiply (1 ulp) where the port
divides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_vision_tpu.ops.pallas_ops import serve_ingest as jax_serve_ingest
from deep_vision_tpu.ops.preprocess import (
    quantize_activations as jax_quantize_activations,
)
from deep_vision_tpu.ops.preprocess import (
    serve_normalize as jax_serve_normalize,
)
from deep_vision_tpu_torch.ops.ingest import serve_ingest, serve_ingest_plain
from deep_vision_tpu_torch.ops.preprocess import (
    make_int8_ingest,
    quantize_activations,
    serve_normalize,
)

CASES = [("imagenet", (3, 17, 23, 3)), ("mnist", (2, 28, 28, 1)),
         ("unit", (2, 9, 11, 3)), ("imagenet", (1, 32, 32, 3))]
#: act_scales: ImageNet's synthetic-calibration scale (2.64/127), a
#: round one, and two that put many codes on half-steps
ACT_SCALES = [2.64 / 127.0, 0.05, 1.0 / 127.0, 0.0208]


def _raw(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("kind,shape", CASES)
@pytest.mark.parametrize("act_scale", ACT_SCALES)
def test_int8_matches_pallas_interpret(kind, shape, act_scale):
    x = _raw(shape, seed=len(shape) + shape[1])
    want = np.asarray(jax_serve_ingest(jnp.asarray(x), kind,
                                       act_scale=act_scale,
                                       interpret=True)).astype(np.int32)
    got = serve_ingest(torch.from_numpy(x), kind, act_scale)
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    got = got.numpy().astype(np.int32)
    assert np.abs(got - want).max() <= 1  # the reference's gate
    mismatches = int((got != want).sum())
    assert mismatches == 0, f"{mismatches} of {got.size} int8 codes differ"


@pytest.mark.parametrize("kind,shape", CASES)
def test_f32_matches_pallas_interpret(kind, shape):
    x = _raw(shape, seed=3)
    want = np.asarray(jax_serve_ingest(jnp.asarray(x), kind, quantize=False,
                                       interpret=True))
    got = serve_ingest(torch.from_numpy(x), kind, quantize=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _every_byte(channels):
    """(1, 1, 256, channels) uint8: every byte value in every channel, the
    256 entries per channel of the table the kernel builds and looks up."""
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(256, dtype=np.uint8)[:, None], (256, channels))
    ).reshape(1, 1, 256, channels)


@pytest.mark.parametrize("kind,shape", CASES)
@pytest.mark.parametrize("act_scale", ACT_SCALES)
def test_matches_xla_prologue(kind, shape, act_scale):
    """Plain ingest == JAX serve_normalize + quantize_activations on a
    seeded image and on every byte value of every channel, int8 and
    float32, and the port's own serve_normalize/quantize_activations
    agree with both."""
    for x in (_raw(shape, seed=11), _every_byte(shape[-1])):
        ref_f = np.asarray(jax_serve_normalize(jnp.asarray(x), kind))
        ref_q = np.asarray(jax_quantize_activations(
            jnp.asarray(ref_f), act_scale)).astype(np.int32)
        xt = torch.from_numpy(x)
        got_f = serve_normalize(xt, kind).numpy()
        np.testing.assert_allclose(got_f, ref_f, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            serve_ingest_plain(xt, kind, act_scale, quantize=False).numpy(),
            ref_f, rtol=0, atol=1e-6)
        got_q = serve_ingest_plain(xt, kind,
                                   act_scale).numpy().astype(np.int32)
        assert np.abs(got_q - ref_q).max() <= 1
        assert int((got_q != ref_q).sum()) == 0
        # quantizing the port's normalize reproduces the fused ingest
        np.testing.assert_array_equal(
            quantize_activations(serve_normalize(xt, kind),
                                 act_scale).numpy(),
            got_q.astype(np.int8))


def test_gan_kind_keeps_plain_path():
    x = torch.from_numpy(_raw((2, 8, 8, 3), seed=5))
    fn = make_int8_ingest("gan", torch.uint8, 0.01)
    want = quantize_activations(serve_normalize(x, "gan"), 0.01)
    assert torch.equal(fn(x), want)
    ref = np.asarray(jax_serve_normalize(jnp.asarray(x.numpy()), "gan"))
    np.testing.assert_allclose(serve_normalize(x, "gan").numpy(), ref,
                               rtol=0, atol=1e-6)


def test_float_wire_only_quantizes():
    y = torch.from_numpy(np.random.RandomState(2).randn(2, 4, 4, 3)
                         .astype(np.float32))
    fn = make_int8_ingest("imagenet", torch.float32, 0.03)
    ref = np.asarray(jax_quantize_activations(jnp.asarray(y.numpy()), 0.03))
    np.testing.assert_array_equal(fn(y).numpy(), ref)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((1, 4, 4, 3), dtype=torch.float32), TypeError),
    (torch.zeros((1, 4, 4, 3), dtype=torch.int8), TypeError),
    (torch.zeros((4, 4, 3), dtype=torch.uint8), ValueError),
    (torch.zeros((1, 3, 4, 4), dtype=torch.uint8).permute(0, 2, 3, 1),
     ValueError),
])
def test_wrapper_rejects(bad, err):
    with pytest.raises(err):
        serve_ingest(bad, "imagenet", 0.02)


def test_wrapper_rejects_unknown_kind_and_channels():
    with pytest.raises(ValueError):
        serve_ingest(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), "gan")
    with pytest.raises(ValueError):
        serve_ingest(torch.zeros((1, 4, 4, 1), dtype=torch.uint8),
                     "imagenet")


def test_cpu_tensor_does_not_count_a_launch():
    before = serve_ingest.launches
    serve_ingest(torch.from_numpy(_raw((1, 4, 4, 3), seed=0)), "imagenet")
    assert serve_ingest.launches == before


@pytest.mark.parametrize("quantize,dtype", [(True, torch.int8),
                                             (False, torch.float32)])
def test_empty_batch(quantize, dtype):
    """An empty batch comes back empty, of the output dtype, uncounted."""
    before = serve_ingest.launches
    out = serve_ingest(torch.zeros((0, 4, 4, 3), dtype=torch.uint8),
                       "imagenet", 0.5, quantize)
    assert out.shape == (0, 4, 4, 3) and out.dtype == dtype
    assert serve_ingest.launches == before


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        serve_ingest(x, "imagenet")


def test_build_sources_and_missing_nvcc(monkeypatch, tmp_path):
    """Every csrc/*.cu is a kernel source with its own library path; a
    machine without nvcc gets a clear error, not a fallback."""
    from deep_vision_tpu_torch.ops import _build

    assert _build.sources() == ["best_iou_max", "serve_ingest",
                                "train_ingest"]
    paths = [_build.library_path(n) for n in _build.sources()]
    for path in paths:
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert len(set(paths)) == 3
    assert paths[1] == _build.library_path("serve_ingest")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()

"""The port's int8 quantization (deep_vision_tpu_torch/serve/quant.py)
against the JAX reference (deep_vision_tpu/serve/quant.py).

Quantization runs in numpy on the host on both sides, so the int8 codes
and per-channel scales must be EQUAL (the reference's flax layout keeps
the output channel last, the port's torch layout first).  Calibration's
ingest scale comes from the same normalized batches, so ``act_scale``
and ``act_absmax`` must be equal too."""

import numpy as np
import pytest
import torch

import jax

from _torch_port import jax_model, load_port, port_model, seeded_variables
from deep_vision_tpu.serve.quant import calibrate as jax_calibrate
from deep_vision_tpu.serve.quant import quantize_params as jax_quantize_params
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.serve.quant import (
    calibrate,
    dequantize_params,
    quantize_model_,
    quantize_params,
    quantize_tensor,
    synthetic_calibration_batches,
)


@pytest.fixture(scope="module")
def tiny():
    jm = jax_model((1, 1), "BottleneckBlock", 10)
    variables = seeded_variables(jm, (32, 32, 3), seed=1)
    return jm, variables


def test_quantize_params_equal_reference(tiny):
    _, variables = tiny
    jq, js = jax_quantize_params(variables["params"])
    jq, js = jax.device_get(jq), jax.device_get(js)
    sd = convert.flax_to_torch(variables, stage_sizes=(1, 1),
                               block="BottleneckBlock")
    q, s = quantize_params(sd)
    # map the reference's trees through the same converter: kernels land
    # transposed into torch layout, scales at their torch keys
    ref = convert.flax_to_torch(
        {"params": jq, "batch_stats": variables["batch_stats"]},
        stage_sizes=(1, 1), block="BottleneckBlock")
    # per-channel scales ride along as (1, ..., 1, cout) kernels
    js_k = jax.tree_util.tree_map(
        lambda sc, k: np.reshape(sc, (1,) * (k.ndim - 1) + (-1,))
        if k.ndim >= 2 else sc, js, jq)
    ref_s = convert.flax_to_torch(
        {"params": js_k, "batch_stats": variables["batch_stats"]},
        stage_sizes=(1, 1), block="BottleneckBlock")
    n_int8 = 0
    for k, v in q.items():
        if sd[k].ndim >= 2:
            assert v.dtype == np.int8, k
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
            np.testing.assert_array_equal(s[k], ref_s[k].reshape(-1),
                                          err_msg=k)
            assert s[k].shape == (sd[k].shape[0],)
            n_int8 += 1
        else:
            np.testing.assert_array_equal(v, sd[k], err_msg=k)
            assert s[k].shape == () and float(s[k]) == 1.0
    assert n_int8 == 10  # stem + 2 blocks × (3 convs + projection) + fc
    # dequantize is within half a step of the float weights
    deq = dequantize_params(q, s)
    for k in q:
        if sd[k].ndim >= 2:
            err = np.abs(deq[k].numpy() - sd[k])
            half = s[k].reshape(-1, *[1] * (sd[k].ndim - 1)) / 2
            assert np.all(err <= half + 1e-7), k


def test_zero_channel_guard():
    w = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    w[2] = 0.0
    q, s = quantize_tensor(torch.from_numpy(w))
    assert float(s[2]) == 1.0
    np.testing.assert_array_equal(q[2], np.zeros(5, np.int8))


@pytest.mark.parametrize("kind", ["imagenet", "unit"])
def test_calibrate_equal_reference(tiny, kind):
    jm, variables = tiny
    batches = synthetic_calibration_batches((32, 32, 3))
    ref = jax_calibrate(jm, variables, batches, kind)
    pm = load_port(port_model((1, 1)), variables)
    got = calibrate(pm, batches, kind)
    assert got.act_scale == ref.act_scale
    assert got.act_absmax == ref.act_absmax
    assert got.batches == ref.batches and got.batch_size == ref.batch_size
    assert got.ranges and all(v > 0 for v in got.ranges.values())


def test_quantized_model_keeps_int8_resident(tiny):
    """After quantize_model_, every conv/fc weight is an int8 buffer with
    its scale, no float copy remains, and the forward equals a float
    model loaded with the dequantized weights."""
    _, variables = tiny
    pm = load_port(port_model((1, 1)), variables)
    f32_bytes = sum(t.numel() * t.element_size()
                    for t in pm.state_dict().values())
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    quantize_model_(pm)
    weights = [m.weight for m in pm.modules()
               if isinstance(getattr(m, "weight", None), torch.Tensor)
               and m.weight.dim() >= 2]
    assert weights and all(w.dtype == torch.int8 for w in weights)
    assert not any(p.dim() >= 2 for p in pm.parameters())
    i8_bytes = sum(t.numel() * t.element_size()
                   for t in pm.state_dict().values())
    assert i8_bytes < 0.3 * f32_bytes
    q, s = quantize_params(sd)
    ref = load_port(port_model((1, 1)), variables)
    ref.load_state_dict({k: v for k, v in dequantize_params(q, s).items()})
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_array_equal(pm(x).numpy(), ref(x).numpy())

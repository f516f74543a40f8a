"""The port's train ingest (deep_vision_tpu_torch/ops/train_ingest.py and
ops/preprocess.py) against the JAX reference: the Pallas ``train_ingest``
in interpret mode fed the factors JAX's ``train_ingest_factors`` drew,
and the XLA ``jitter_normalize`` with the same key.

On the CPU the wrapper computes the plain PyTorch version; the CUDA
kernel is held against that same plain version on the card by
``chip_smoke.py``.  Tolerances: 1e-5 against the interpret-mode kernel
(the reference computes gray as a matmul and XLA may reassociate the
per-pixel sum, a few ulps on values of order 2), 1e-4 against
``jitter_normalize`` (the reference's own kernel-vs-XLA bar,
``train_ingest_parity_ok``; its per-image mean is a float sum where the
kernel path takes ``fb·mean``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port  # noqa: F401  (two torch threads in the parallel lane)
from deep_vision_tpu.ops.pallas_ops import train_ingest as jax_train_ingest
from deep_vision_tpu.ops.pallas_ops import (
    train_ingest_factors as jax_train_ingest_factors,
)
from deep_vision_tpu.ops.preprocess import (
    jitter_normalize as jax_jitter_normalize,
)
from deep_vision_tpu_torch.ops.preprocess import (
    jitter_normalize,
    make_imagenet_preprocess,
    serve_normalize,
)
from deep_vision_tpu_torch.ops.train_ingest import (
    MIN_TILED_IMAGE,
    division_magic,
    tiled_path,
    train_ingest,
    train_ingest_factors,
    train_ingest_plain,
)

SHAPES = [(4, 32, 32, 3), (2, 24, 40, 3), (3, 17, 23, 3), (2, 224, 224, 3),
          (2, 299, 299, 3)]
#: the kernel's (batch, pixels an image) on the main path (chip_smoke.py's
#: TRAIN_SHAPES and ZOO_TRAIN_SHAPES) and at its edge cases
KERNEL_SHAPES = [(256, 224 * 224), (32, 224 * 224), (1, 224 * 224),
                 (3, 17 * 23), (128, 224 * 224), (128, 299 * 299),
                 (1024, 224 * 224), (129, 299 * 299), (64, 6), (70000, 16)]


def _raw(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_interpret_and_xla(shape):
    x = _raw(shape, seed=shape[1])
    key = jax.random.PRNGKey(shape[2])
    factors = jax_train_ingest_factors(jnp.asarray(x), key)
    want = np.asarray(jax_train_ingest(jnp.asarray(x), factors,
                                       interpret=True))
    got = train_ingest(torch.from_numpy(x),
                       torch.from_numpy(np.array(factors)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    xla = np.asarray(jax_jitter_normalize(jnp.asarray(x), key, train=True))
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    x = torch.from_numpy(_raw((3, 17, 23, 3), 1))
    f = train_ingest_factors(x, torch.Generator().manual_seed(0))
    before = train_ingest.launches
    assert torch.equal(train_ingest(x, f), train_ingest_plain(x, f))
    assert train_ingest.launches == before  # the CPU launches no kernel


def test_factor_draw_ranges_mean_and_seed():
    x = torch.from_numpy(_raw((512, 8, 8, 3), 2))
    f = train_ingest_factors(x, torch.Generator().manual_seed(7),
                             brightness=0.2, contrast=0.4, saturation=1.5)
    assert f.shape == (512, 4) and f.dtype == torch.float32
    for col, a in ((0, 0.2), (1, 0.4), (2, 1.5)):
        lo, hi = max(0.0, 1 - a), 1 + a
        v = f[:, col]
        assert float(v.min()) >= lo and float(v.max()) < hi
        # uniform over the range: the sample spans most of it
        assert float(v.min()) < lo + 0.05 * (hi - lo)
        assert float(v.max()) > hi - 0.05 * (hi - lo)
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.05 * (hi - lo)
    want_m = f[:, 0].double() * (x.double() / 255.0).mean(dim=(1, 2, 3))
    np.testing.assert_allclose(f[:, 3].numpy(), want_m.numpy(), rtol=1e-6)
    again = train_ingest_factors(x, torch.Generator().manual_seed(7),
                                 brightness=0.2, contrast=0.4,
                                 saturation=1.5)
    assert torch.equal(f, again)
    other = train_ingest_factors(x, torch.Generator().manual_seed(8),
                                 brightness=0.2, contrast=0.4,
                                 saturation=1.5)
    assert not torch.equal(f[:, :3], other[:, :3])


def test_port_jitter_normalize_equals_kernel_path_from_one_seed():
    """The port's XLA-path copy draws the factors the kernel path draws
    from the same generator seed, so the two agree (1e-5: the float
    per-image mean against fb·mean of the integer sum)."""
    x = torch.from_numpy(_raw((4, 24, 40, 3), 3))
    got = train_ingest(x, train_ingest_factors(
        x, torch.Generator().manual_seed(5)))
    want = jitter_normalize(x, torch.Generator().manual_seed(5), True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # eval: plain normalize, identical to the JAX reference's eval branch
    ref = np.asarray(jax_jitter_normalize(jnp.asarray(x.numpy()), None,
                                          train=False))
    np.testing.assert_allclose(jitter_normalize(x, None, False).numpy(),
                               ref, rtol=0, atol=1e-6)


def test_imagenet_preprocess_train_eval_and_float_passthrough():
    fn = make_imagenet_preprocess()
    x = torch.from_numpy(_raw((2, 16, 16, 3), 4))
    batch = {"image": x, "label": torch.tensor([1, 2])}
    train = fn(batch, torch.Generator().manual_seed(9), True)
    want = train_ingest_plain(x, train_ingest_factors(
        x, torch.Generator().manual_seed(9)))
    assert torch.equal(train["image"], want)
    assert train["label"] is batch["label"]
    ev = fn(batch, None, False)
    assert torch.equal(ev["image"], serve_normalize(x, "imagenet"))
    xf = {"image": torch.ones(2, 16, 16, 3)}
    assert fn(xf, None, True) is xf


@pytest.mark.parametrize("bad,err", [
    (lambda x, f: (x.float(), f), TypeError),
    (lambda x, f: (x[..., :1].contiguous(), f), ValueError),
    (lambda x, f: (x.transpose(1, 2), f), ValueError),
    (lambda x, f: (x, f[:1]), ValueError),
])
def test_rejects_bad_input(bad, err):
    x = torch.from_numpy(_raw((2, 8, 8, 3), 5))
    f = train_ingest_factors(x, torch.Generator().manual_seed(0))
    with pytest.raises(err):
        train_ingest(*bad(x, f))


def test_empty_batch():
    x = torch.empty((0, 8, 8, 3), dtype=torch.uint8)
    out = train_ingest(x, torch.empty((0, 4)))
    assert out.shape == x.shape and out.dtype == torch.float32


def _magic_quotient(q, magic, shift):
    """``((q·magic) >> 64) >> shift`` in uint64 numpy for q < 2**32: the
    product split at magic's 32-bit halves."""
    hi, lo = np.uint64(magic >> 32), np.uint64(magic & 0xFFFFFFFF)
    mid = q * hi + ((q * lo) >> np.uint64(32))
    return mid >> np.uint64(32 + shift)


@pytest.mark.parametrize("batch,pixels", KERNEL_SHAPES)
def test_division_magic_every_pixel(batch, pixels):
    """The kernel's image of pixel q, umulhi(q, magic) >> shift, is
    q // pixels for every pixel of the batch."""
    total = batch * pixels
    magic, shift = division_magic(pixels, total)
    assert 0 <= magic < 2 ** 64 and 0 <= shift < 64
    step = 1 << 22
    for start in range(0, total, step):
        q = np.arange(start, min(start + step, total), dtype=np.uint64)
        np.testing.assert_array_equal(_magic_quotient(q, magic, shift),
                                      q // np.uint64(pixels))


@pytest.mark.parametrize("pixels", [2, 3, 16, 17, 391, 50176, 89401,
                                    2 ** 31 - 1, 2 ** 32 + 7, 2 ** 40 - 3])
@pytest.mark.parametrize("total_bits", [20, 40, 63])
def test_division_magic_ends_of_range(pixels, total_bits):
    """Exact at the ends of q's range, around every image boundary there,
    and at the largest total (2**63), in Python's exact integers."""
    total = 1 << total_bits
    magic, shift = division_magic(pixels, total)
    assert 0 <= magic < 2 ** 64 and 0 <= shift < 64
    last = (total - 1) // pixels * pixels
    qs = {0, 1, pixels - 1, pixels, pixels + 1, total - 1, total - 2,
          last, last - 1, last - pixels, last - pixels - 1}
    for q in sorted(v for v in qs if 0 <= v < total):
        assert ((q * magic) >> 64) >> shift == q // pixels, q


def test_division_magic_one_pixel_and_bad_input():
    assert division_magic(1, 12345) == (0, 0)  # the kernel skips it
    for pixels, total in ((0, 10), (-3, 10), (4, -1), (4, 2 ** 63 + 1)):
        with pytest.raises(ValueError):
            division_magic(pixels, total)


@pytest.mark.parametrize("x_ptr,out_ptr,pixels,tiled", [
    (0x7F0000000000, 0x7F0000100000, 224 * 224, True),
    (0x7F0000000000, 0x7F0000100000, 299 * 299, True),
    # x[1:] of a 299² batch: 268,203 bytes on, no multiple of 16
    (0x7F0000000000 + 299 * 299 * 3, 0x7F0000100000, 299 * 299, False),
    (0x7F0000000008, 0x7F0000100000, 224 * 224, False),
    (0x7F0000000000, 0x7F0000100004, 224 * 224, False),
    (0x7F0000000000, 0x7F0000100000, MIN_TILED_IMAGE, True),
    (0x7F0000000000, 0x7F0000100000, MIN_TILED_IMAGE - 1, False),
    (0x7F0000000000, 0x7F0000100000, 6, False),
])
def test_tiled_path_needs_aligned_bases_and_16_pixel_images(
        x_ptr, out_ptr, pixels, tiled):
    assert tiled_path(x_ptr, out_ptr, pixels) is tiled

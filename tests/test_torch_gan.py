"""The port's GAN networks (``deep_vision_tpu_torch/models/gan.py``) on
the CPU, against the JAX reference: the four networks in eval and
training mode (outputs and the updated BatchNorm statistics), the
flax-exact ``ConvTranspose2d`` at every (kernel, stride) of the family
with an unflipped-kernel control that must fail, ``convert.py``'s GAN
converters strict both ways, and the int8 codes and scales of every
kernel (the transposed ones included) equal to the reference's
``quantize_params``.

Tolerances: outputs within 1e-4 of their largest magnitude (float32
convolutions summed in other orders, through up to 14 layers; a tanh
output's linear region passes the pre-activation's rounding on),
running statistics within 1e-5 relative; converters and int8 codes
exact."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from _torch_port import seeded_variables
from _torch_zoo import FlaxMasks
from deep_vision_tpu.models import gan as jgan
from deep_vision_tpu.serve.quant import quantize_params as jax_quantize
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.models.common import ConvTranspose2d
from deep_vision_tpu_torch.serve.quant import quantize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-4
STATS_BOUND = 1e-5

#: name → (flax model, port model, one input's shape)
NETS = {
    "dcgan_generator": (lambda: jgan.DCGANGenerator(),
                        lambda: gan.DCGANGenerator(), (100,)),
    "dcgan_discriminator": (lambda: jgan.DCGANDiscriminator(),
                            lambda: gan.DCGANDiscriminator(), (28, 28, 1)),
    "cyclegan_generator": (lambda: jgan.CycleGANGenerator(n_blocks=2),
                           lambda: gan.CycleGANGenerator(2), (32, 32, 3)),
    "patchgan": (lambda: jgan.PatchGANDiscriminator(),
                 lambda: gan.PatchGANDiscriminator(), (32, 32, 3)),
}


def _variables(name, seed=0):
    """Seeded flax variables (He-scaled kernels, non-zero BN scales); a
    latent-in generator's Dense kernel is scaled by 1/sqrt(fan-in)."""
    jm, _, shape = NETS[name]
    if len(shape) == 3:
        return seeded_variables(jm(), shape, seed=seed)
    shapes = jax.eval_shape(lambda: jm().init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, *shape))))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shp = tuple(s.shape)
        if name == "kernel" and len(shp) == 4:
            a = rng.randn(*shp) * np.sqrt(2.0 / (shp[0] * shp[1] * shp[2]))
        elif name == "kernel":
            a = rng.randn(*shp) / np.sqrt(shp[0])
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shp)
        else:
            a = rng.randn(*shp) * 0.1
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(name, seed=0):
    jm, pm, shape = NETS[name]
    v = _variables(name, seed)
    model = pm()
    convert.load_gan(model, v)
    return jm(), model, v, shape


def _inputs(shape, n=3, seed=1):
    x = np.random.RandomState(seed).randn(n, *shape).astype(np.float32)
    return x if len(shape) == 1 else np.tanh(x)


def _close(got, want, bound=BOUND):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(NETS))
def test_eval_forward_matches_flax(name):
    jm, model, v, shape = _pair(name)
    x = _inputs(shape)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    _close(got, ref)


@pytest.mark.parametrize("name", sorted(NETS))
def test_train_forward_and_bn_statistics_match_flax(name):
    """Training mode: the batch statistics normalize, the running ones
    move with flax's default momentum 0.99 (DCGAN's discriminator has
    no BatchNorm: its two dropout masks, NHWC, go in as they are)."""
    jm, model, v, shape = _pair(name)
    x = _inputs(shape)
    masks = FlaxMasks(seed=7)
    with fnn.intercept_methods(masks):
        out = jm.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"], rngs={
                           "dropout": jax.random.PRNGKey(0)})
    ref, new_vars = out
    model.train()
    kw = {}
    if name == "dcgan_discriminator":
        assert [m.shape[1:] for m in masks.masks] == \
            [tuple(s) for s in gan.DCGANDiscriminator.MASK_SHAPES]
        kw["masks"] = [torch.from_numpy(m) for m in masks.masks]
    got = model(torch.from_numpy(x), **kw).detach().numpy()
    _close(got, ref)
    stats = new_vars.get("batch_stats", {})
    if not stats:
        assert name == "dcgan_discriminator"
        return
    want = convert.gan_from_flax({"params": v["params"],
                                  "batch_stats": jax.device_get(stats)},
                                 model)
    sd = model.state_dict()
    running = [k for k in want if k.endswith(("running_mean",
                                              "running_var"))]
    assert running
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), want[k],
                                   rtol=STATS_BOUND, atol=STATS_BOUND,
                                   err_msg=k)


#: every (kernel, stride, input size) of the family's transposed convs:
#: DCGAN's 5×5/1 at 7², 5×5/2 at 7² and 14², CycleGAN's 3×3/2 (64² at
#: full size), and an odd size
CONV_T = [(5, 1, 7), (5, 2, 7), (5, 2, 14), (3, 2, 16), (3, 2, 9)]


def _flax_conv_t(k, s, size, seed):
    layer = fnn.ConvTranspose(4, (k, k), (s, s), padding="SAME",
                              use_bias=False)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, size, size, 6).astype(np.float32)
    kernel = rng.randn(k, k, 6, 4).astype(np.float32)
    ref = layer.apply({"params": {"kernel": kernel}}, jnp.asarray(x))
    return x, kernel, np.asarray(ref)


@pytest.mark.parametrize("k,s,size", CONV_T)
def test_conv_transpose_matches_flax(k, s, size):
    x, kernel, ref = _flax_conv_t(k, s, size, seed=k + s + size)
    assert ref.shape == (2, size * s, size * s, 4)
    layer = ConvTranspose2d(6, 4, k, s)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)) \
        .permute(0, 2, 3, 1).detach().numpy()
    _close(got, ref)


@pytest.mark.parametrize("k,s,size", CONV_T)
def test_conv_transpose_unflipped_kernel_fails(k, s, size):
    """The control: ``conv_transpose2d`` with flax's kernel merely
    transposed to (in, out, kH, kW), not flipped, is another function."""
    x, kernel, ref = _flax_conv_t(k, s, size, seed=k + s + size)
    layer = ConvTranspose2d(6, 4, k, s)
    w = torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, None, s,
        layer.transpose_padding, layer.output_pad)
    if layer.crop:
        got = got[:, :, :-layer.crop, :-layer.crop]
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() > 100 * BOUND * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(NETS))
def test_converters_round_trip_and_are_strict(name):
    jm, model, v, _ = _pair(name)
    back = convert.gan_to_flax(
        {k: t.numpy() for k, t in model.state_dict().items()}, model)
    flat, want = convert.flatten_tree(back), convert.flatten_tree(v)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    extra = convert.unflatten_tree(dict(want, **{"params/Extra_0/kernel":
                                                 np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="no module"):
        convert.load_gan(NETS[name][1](), extra)
    first = sorted(k for k in want if k.startswith("params/"))[0]
    missing = convert.unflatten_tree({k: a for k, a in want.items()
                                      if k != first})
    with pytest.raises(KeyError):
        convert.load_gan(NETS[name][1](), missing)


def test_converters_refuse_another_family():
    _, _, v, _ = _pair("dcgan_generator")
    with pytest.raises(KeyError):
        convert.load_gan(gan.DCGANDiscriminator(), v)
    with pytest.raises(TypeError, match="no GAN layout"):
        convert.gan_leaves(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("name", sorted(NETS))
def test_int8_codes_and_scales_equal_reference(name):
    """Every kernel (Dense, conv and transposed conv) quantizes to the
    reference's int8 codes and per-output-channel scales: the port
    keeps each weight output-first, so its dim-0 scale is the
    reference's trailing-axis one."""
    _, model, v, _ = _pair(name)
    jq, js = jax_quantize(v["params"])
    jq, js = convert.flatten_tree(jq), convert.flatten_tree(js)
    q, s = quantize_params(model.state_dict())
    held = 0
    for kind, t, path, *_ in convert.gan_leaves(model):
        if kind not in ("conv", "convk", "dense", "densek"):
            continue
        key = "/".join(path) + "/kernel"
        code, scale = q[f"{t}.weight"], s[f"{t}.weight"]
        assert code.dtype == np.int8
        want = jq[key]
        port = code.T if code.ndim == 2 else code.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(port, want, err_msg=key)
        np.testing.assert_array_equal(scale, js[key], err_msg=key)
        held += 1
    transposed = sum(isinstance(m, ConvTranspose2d)
                     for m in model.modules())
    assert held >= 3 and (transposed > 0) == ("generator" in name)


def test_gan_modules_import_without_jax():
    """The new modules stand alone: importing them with JAX, flax,
    optax and the JAX package blocked pulls in none of them."""
    mods = ["deep_vision_tpu_torch.models.gan",
            "deep_vision_tpu_torch.tasks.gan",
            "deep_vision_tpu_torch.core.adversarial",
            "deep_vision_tpu_torch.data.gan",
            "deep_vision_tpu_torch.zoo.gan",
            "deep_vision_tpu_torch.cli.train",
            "deep_vision_tpu_torch.serve.workloads"]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "             'deep_vision_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'deep_vision_tpu') and sys.modules[n] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == "ok"

"""``cli.infer`` classify, sample and translate against the reference's
``cli.infer`` on the same weights, and ``viz.py`` against the
reference's drawing (detect and pose: tests/test_torch_infer_detect.py;
eval: tests/test_torch_infer_eval.py).

The port reads workdirs its trainer's checkpointer writes; the
reference's ``_load_state`` is pointed at the same seeded flax
variables (its own reads Orbax checkpoints), so both CLIs run their own
code end to end on one set of weights and one set of image files."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_infer as ti
import _torch_serve as ts
from deep_vision_tpu import viz as jax_viz
from deep_vision_tpu.cli import infer as jinfer
from deep_vision_tpu_torch import convert, viz
from deep_vision_tpu_torch.cli import infer


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("DEEP_VISION_TPU_NO_COMPILE_CACHE", "1")


def test_classify_top5_equals_reference(tmp_path, capsys, monkeypatch):
    v = ts.lenet_variables(4)
    wd = ti.workdir(tmp_path, "lenet5", v)
    ti.point_reference(monkeypatch, "lenet5", v)
    imgs = ti.images(tmp_path, 3, (40, 36))
    argv = ["classify", "-m", "lenet5", "--workdir", wd, "--images", *imgs]
    assert jinfer.main(argv) == 0
    want = ti.lines(capsys, str(tmp_path))
    assert infer.main(argv + ["--device", "cpu"]) == 0
    got = ti.lines(capsys, str(tmp_path))
    assert len(got) == 3 and got == want


def test_draw_detections_equals_reference():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    boxes = np.array([[0.1, 0.2, 0.5, 0.6], [0.0, 0.0, 1.0, 1.0],
                      [0.7, 0.05, 0.9, 0.3]], np.float32)
    scores = np.array([0.9, 0.4, 0.05], np.float32)
    classes = np.array([1, 14, 30])
    for kw in (dict(), dict(class_names=list(infer.VOC_CLASSES)),
               dict(min_score=0.3)):
        np.testing.assert_array_equal(
            viz.draw_detections(img, boxes, scores, classes, **kw),
            jax_viz.draw_detections(img, boxes, scores, classes, **kw))
    assert infer.VOC_CLASSES == __import__(
        "deep_vision_tpu.data.prep", fromlist=["VOC_CLASSES"]).VOC_CLASSES


def test_draw_keypoints_equals_reference():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (120, 90, 3), dtype=np.uint8)
    kp = rng.uniform(0, 90, (16, 2)).astype(np.float32)
    vis = (rng.random(16) > 0.3).astype(np.float32)
    for kw in (dict(), dict(visible=vis), dict(visible=vis, skeleton=None)):
        np.testing.assert_array_equal(viz.draw_keypoints(img, kp, **kw),
                                      jax_viz.draw_keypoints(img, kp, **kw))


def _gan_workdir(tmp_path, name, seed):
    """A port adversarial checkpoint of ``name``'s networks (seeded)."""
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.optim import OptimizerConfig as PortOpt
    from deep_vision_tpu_torch.core.optim import build_optimizer as port_opt
    from deep_vision_tpu_torch.core.state import TrainState
    from deep_vision_tpu_torch.models import gan as gan_models

    if name == "dcgan":
        nets = {"generator": gan_models.DCGANGenerator(),
                "discriminator": gan_models.DCGANDiscriminator()}
    else:
        nets = {"gen_a2b": gan_models.CycleGANGenerator(),
                "gen_b2a": gan_models.CycleGANGenerator()}
    states = {}
    for i, (k, m) in enumerate(nets.items()):
        m.reset_parameters(torch.Generator().manual_seed(seed + i))
        states[k] = TrainState(m, port_opt(PortOpt(), m), 0)
    wd = str(tmp_path / name)
    Checkpointer(os.path.join(wd, "checkpoints")).save_tree(4, states)
    return wd, nets


def test_sample_writes_the_generators_grid(tmp_path):
    """``sample`` writes the grid of the checkpoint generator's forward
    on latents from the seeded ``torch.Generator``; that forward equals
    the reference generator's on the same latents (its own latents come
    from a JAX PRNGKey, which torch cannot reproduce)."""
    from deep_vision_tpu.models import gan as jgan

    wd, nets = _gan_workdir(tmp_path, "dcgan", seed=6)
    out = str(tmp_path / "s.png")
    assert infer.main(["sample", "-m", "dcgan", "--workdir", wd, "-n", "6",
                       "--out", out, "--seed", "3", "--device", "cpu"]) == 0
    gen = nets["generator"].eval()
    z = infer.sample_latents(6, gen.latent_dim, 3, "cpu")
    imgs = infer.generate(gen, z)
    got = np.asarray(Image.open(out))
    np.testing.assert_array_equal(got, infer.grid_image(imgs))
    assert got.shape == (2 * 28, 4 * 28)
    variables = convert.gan_to_flax(
        {k: t.numpy() for k, t in gen.state_dict().items()}, gen)
    want = jgan.DCGANGenerator().apply(variables, z.numpy(), train=False)
    np.testing.assert_allclose(imgs, np.asarray(want), rtol=0, atol=1e-5)


def test_translate_writes_the_generators_images(tmp_path):
    wd, nets = _gan_workdir(tmp_path, "cyclegan", seed=2)
    imgs = ti.images(tmp_path, 1, (256, 256, 3), seed=4)
    out_dir = str(tmp_path / "out")
    assert infer.main(["translate", "-m", "cyclegan", "--workdir", wd,
                       "--images", *imgs, "--direction", "b2a",
                       "--out-dir", out_dir, "--device", "cpu"]) == 0
    x = np.asarray(Image.open(imgs[0])).astype(np.float32) / 127.5 - 1.0
    y = infer.generate(nets["gen_b2a"].eval(), torch.from_numpy(x[None]))[0]
    want = ((y + 1) * 127.5).clip(0, 255).astype(np.uint8)
    got = np.asarray(Image.open(os.path.join(out_dir, "img0.png")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["dcgan", "cyclegan"])
def test_eval_rejects_gan_configs(tmp_path, name):
    for main in (jinfer.main, infer.main):
        with pytest.raises(SystemExit, match="eval does not support"):
            main(["eval", "-m", name, "--workdir", str(tmp_path),
                  "--synthetic"] + (["--device", "cpu"]
                                    if main is infer.main else []))


def test_infer_requires_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["export", "-m", "lenet5", "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)

"""The port's CenterNet training path (deep_vision_tpu_torch:
tasks/centernet.py labels, loss and eval, data/detection.py
CenterNetLoader, cli.train -m centernet_toy) against the JAX reference,
on the CPU at the ``centernet_toy`` size.  One trainer step against the
JAX ``Trainer`` is tests/test_torch_centernet_step.py.

Tolerances, each with its reason:

- ``gaussian_radius`` and ``encode_centernet_labels``: exact (the same
  numpy code: the Gaussians in float64, then a float32 ``max``).
- ``focal_loss``, ``CenterNetTask.loss``/``eval_metrics`` and their
  gradients with respect to the heads against ``jax.grad``: within
  1e-4 of the largest magnitude (float32 sums in other orders).  The
  heads are seeded at a trained model's scale (heatmap logits around
  the −2.19 prior): at He scale every sigmoid rounds to 1.0 and the
  focal loss's gradient vanishes.
- ``eval_outputs``: the decode's classes and valid flags exact, scores
  within 1e-6, boxes within 1e-5 (tests/test_torch_centernet.py holds
  the decode itself on ties).
- Loader batches: labels exact; images exact (CenterNet takes no crop,
  and the scenes are stored at the input size).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port  # noqa: F401  (two intra-op threads)
from deep_vision_tpu.data import detection as jax_data
from deep_vision_tpu.tasks import centernet as jax_task
from deep_vision_tpu_torch.data import detection as port_data
from deep_vision_tpu_torch.tasks import centernet as port_task

SIZE, BATCH, CLASSES, SEED = 64, 4, 3, 3
BOUND = 1e-4


def _boxes(n, seed, border=False):
    """``n`` normalized centroid boxes; ``border`` puts centres on and
    past the image's edges and adds tiny and whole-image boxes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 1.0, (n, 2))
    wh = rng.uniform(0.02, 0.6, (n, 2))
    if border:
        xy[: n // 2] = rng.choice([0.0, 1.0, 0.999, 1e-4], (n // 2, 2))
        wh[::3] = rng.choice([1e-3, 1.0], (len(wh[::3]), 2))
    return np.concatenate([xy, wh], 1).astype(np.float32), \
        rng.integers(0, CLASSES, n)


def test_gaussian_radius_matches_reference():
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.uniform(0, 64, 200), [0.0, 0.0, 1e-3, 64.0]])
    w = np.concatenate([rng.uniform(0, 64, 200), [0.0, 5.0, 1e-3, 64.0]])
    for min_iou in (0.7, 0.5):
        np.testing.assert_array_equal(
            port_task.gaussian_radius(h, w, min_iou),
            jax_task.gaussian_radius(h, w, min_iou))


@pytest.mark.parametrize("n,border", [(0, False), (1, False), (100, False),
                                      (120, False), (40, True)])
def test_encode_labels_match_reference(n, border):
    boxes, classes = _boxes(n, seed=n + 1, border=border)
    for grid in (16, 64):
        want = jax_task.encode_centernet_labels(boxes, classes, CLASSES, grid)
        got = port_task.encode_centernet_labels(boxes, classes, CLASSES,
                                                grid)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["obj_mask"].sum() == min(n, port_task.MAX_OBJECTS)
        if n:
            assert (got["heatmap"] == 1.0).any()


def _heads(seed, b=BATCH, g=SIZE // 4, c=CLASSES, stacks=2):
    """Seeded head outputs at a trained model's scale: heatmap logits
    around the −2.19 prior, wh a few cells, offsets in [0, 1)."""
    rng = np.random.default_rng(seed)
    return [tuple(a.astype(np.float32) for a in (
        rng.normal(-2.19, 1.5, (b, g, g, c)),
        rng.uniform(0.5, 6.0, (b, g, g, 2)),
        rng.uniform(0.0, 1.0, (b, g, g, 2)))) for _ in range(stacks)]


def _labels(seed, b=BATCH, g=SIZE // 4, weight=True):
    items = [jax_task.encode_centernet_labels(
        *_boxes(k, seed + k), CLASSES, g) for k in range(b)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    if weight:
        batch["weight"] = np.array([1.0] * (b - 1) + [0.0], np.float32)
    return batch


def _close(got, want, what=""):
    want = np.asarray(want)
    assert np.shape(got) == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BOUND * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_focal_loss_and_gradient_match_reference():
    (heat, _, _), _ = _heads(4)
    gt = _labels(5)["heatmap"]
    want, want_g = jax.value_and_grad(
        lambda x: jax_task.focal_loss(x, gt).sum())(jnp.asarray(heat))
    x = torch.from_numpy(heat).requires_grad_()
    per = port_task.focal_loss(x, torch.from_numpy(gt))
    per.sum().backward()
    _close(per.detach().numpy(), jax_task.focal_loss(heat, gt), "per image")
    _close(float(per.sum()), want)
    _close(x.grad.numpy(), want_g, "grad")


def _torch_heads(heads):
    return [tuple(torch.from_numpy(a).requires_grad_() for a in stack)
            for stack in heads]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_task_loss_eval_and_gradients_match_reference():
    heads, batch = _heads(6), _labels(7)
    jt, pt = jax_task.CenterNetTask(CLASSES), port_task.CenterNetTask(
        CLASSES)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(outs):
        return jt.loss(outs, jb)[0]

    want_loss, want_comps = jt.loss(heads, jb)
    want_grads = jax.grad(total)([tuple(map(jnp.asarray, s)) for s in heads])
    th = _torch_heads(heads)
    loss, comps = pt.loss(th, _torch_batch(batch))
    loss.backward()
    _close(float(loss), want_loss)
    assert set(comps) == set(want_comps)
    for k, v in want_comps.items():
        _close(float(comps[k]), v, k)
    for s, (g_stack, w_stack) in enumerate(zip(th, want_grads)):
        for name, g, w in zip(("heat", "wh", "offset"), g_stack, w_stack):
            _close(g.grad.numpy(), w, f"grad {name}_{s}")
    with torch.no_grad():
        got_m = pt.eval_metrics([tuple(t.detach() for t in s) for s in th],
                                _torch_batch(batch))
    want_m = jt.eval_metrics(heads, jb)
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        _close(float(got_m[k]), v, k)
    assert float(got_m["count"]) == BATCH - 1  # the weight-0 filler row


def test_eval_outputs_match_reference():
    heads, batch = _heads(8), _labels(9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_task.CenterNetTask(CLASSES).eval_outputs(heads, jb)
    got = port_task.CenterNetTask(CLASSES).eval_outputs(
        [tuple(map(torch.from_numpy, s)) for s in heads], _torch_batch(batch))
    assert set(got) == set(want)
    for k in ("det_classes", "det_valid", "gt_boxes", "gt_mask",
              "gt_classes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["det_scores"].numpy(),
                               np.asarray(want["det_scores"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["det_boxes"].numpy(),
                               np.asarray(want["det_boxes"]), rtol=0,
                               atol=1e-5)
    assert 0 < float(got["det_valid"].sum()) < got["det_valid"].numel()


def _scenes(n=10, seed=0):
    return jax_data.synthetic_detection_dataset(n, SIZE, CLASSES, seed=seed)


@pytest.mark.parametrize("train", [True, False])
def test_loader_matches_reference(train):
    samples = _scenes()
    kw = dict(train=train, seed=SEED, device_normalize=True)
    want = jax_data.CenterNetLoader(samples, BATCH, CLASSES, SIZE, **kw)
    got = port_data.CenterNetLoader(samples, BATCH, CLASSES, SIZE, **kw)
    for epoch in (1, 2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        w_batches, g_batches = list(want), list(got)
        assert len(g_batches) == len(w_batches) == (2 if train else 3)
        for g, w in zip(g_batches, w_batches):
            assert set(g) == set(w)
            assert g["heatmap"].shape == (BATCH, SIZE // 4, SIZE // 4,
                                          CLASSES)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pooled_batches_equal_inline():
    samples = _scenes(12, seed=5)
    inline = port_data.CenterNetLoader(samples, BATCH, CLASSES, SIZE,
                                       seed=SEED, device_normalize=True)
    pooled = port_data.CenterNetLoader(samples, BATCH, CLASSES, SIZE,
                                       seed=SEED, device_normalize=True,
                                       num_workers=2)
    try:
        for epoch in (1, 2):
            inline.set_epoch(epoch)
            pooled.set_epoch(epoch)
            a, b = list(inline), list(pooled)
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    finally:
        pooled.close()


# -- cli.train on the CPU ------------------------------------------------------


def test_cli_train_centernet_toy_on_cpu_with_resume(tmp_path, capsys):
    """cli.train -m centernet_toy on raw records written by the port:
    one epoch of 2 steps with a checkpoint, then a resumed second epoch;
    the loader's worker pool carries the dense labels."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.data import records as port_records

    data, work = str(tmp_path / "data"), tmp_path / "work"
    port_records.write_detection_records(_scenes(16, seed=8), data, "train",
                                         2, num_workers=1, store="raw",
                                         resize=SIZE)
    port_records.write_detection_records(_scenes(6, seed=9), data, "val", 1,
                                         num_workers=1, store="raw",
                                         resize=SIZE)
    argv = ["-m", "centernet_toy", "--data-root", data, "--workdir",
            str(work), "--num-workers", "2", "--device", "cpu"]
    assert cli.main(argv + ["--epochs", "1"]) == 0
    saved = Checkpointer(str(work / "checkpoints")).load(2)["state"]
    assert int(saved["optimizer"]["count"]) == 2
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step=2 start_epoch=2" in out
    assert "final: loss=" in out and "mAP=" in out
    assert sorted(os.listdir(work / "checkpoints")) == ["2", "4"]
    assert os.listdir(work / "checkpoints_best")  # monitored on mAP
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    losses = [d for d in lines if d["name"] == "train_loss"]
    assert [d["step"] for d in losses] == [2, 4]
    assert all(np.isfinite(d["value"]) for d in losses)
    names = {d["name"] for d in lines}
    assert {"val_mAP", "val_loss", "train_heat_0", "train_wh_0",
            "train_off_0", "input_stall_frac"} <= names


def test_profile_centernet_train_step_on_cpu(capsys):
    from deep_vision_tpu_torch.obs import profile

    assert profile.main(["-m", "centernet_toy", "--train", "--device",
                         "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batch"] == 8 and rep["wall_ms_per_step"] > 0
    assert rep["device_busy_ms_per_step"] is None  # no device on the CPU

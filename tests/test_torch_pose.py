"""The port's pose path (deep_vision_tpu_torch: tasks/pose.py,
models/hourglass.py StackedHourglass, convert.py, data/pose.py,
data/records.py pose records, cli.train -m hourglass_toy) against the
JAX reference, on the CPU at the ``hourglass_toy`` size.  One trainer
step against the JAX ``Trainer`` is tests/test_torch_pose_step.py.

Tolerances, each with its reason:

- ``make_heatmaps``, ``heatmap_argmax``, ``pckh``, ``crop_roi`` and the
  loader's labels: exact (the same numpy code; ``np.round`` rounds half
  to even on both sides).
- ``decode_heatmaps``: exact, with and without ``refine``, on tied,
  flat and border peaks (``torch.argmax`` takes the first maximum, as
  ``jnp.argmax`` does).
- ``PoseTask.loss``/``eval_metrics`` and the loss's gradient with
  respect to every stack's heatmaps against ``jax.grad``: within 1e-4
  of the largest magnitude (float32 means in other orders).
- ``StackedHourglass`` against flax at float32, eval and train mode
  (batch statistics, and the running statistics' update): within 1e-4
  of the largest magnitude; the converters round-trip exactly.
- Loader images: within 1 grey level (the port resizes every crop with
  torch's bilinear, the reference with cv2's ``INTER_LINEAR``); exact
  where the crop needs no resize.
- Raw pose records: headers equal; payloads byte-equal where the image
  is already at the store's size, else within 1 grey level.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import seeded_variables
from deep_vision_tpu.data import pose as jax_data
from deep_vision_tpu.data import records as jax_records
from deep_vision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deep_vision_tpu.tasks import pose as jax_task
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.data import pose as port_data
from deep_vision_tpu_torch.data import records as port_records
from deep_vision_tpu_torch.models.common import BatchNorm2d
from deep_vision_tpu_torch.models.hourglass import StackedHourglass
from deep_vision_tpu_torch.tasks import pose as port_task

BOUND = 1e-4
SIZE, BATCH, KP, SEED = 64, 4, 8, 3


def _close(got, want, what=""):
    want = np.asarray(want)
    assert np.shape(got) == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BOUND * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# -- targets, decode, PCKh -----------------------------------------------------


def test_make_heatmaps_match_reference():
    kp = np.array([
        [10.0, 12.0, 1.0],      # inside
        [2.5, 3.5, 1.0],        # halves: round to even → (2, 4)
        [-2.5, 30.0, 1.0],      # → −2: the support reaches the map
        [-4.0, 30.0, 1.0],      # the support lies wholly outside
        [66.4, 20.0, 1.0],      # → 66: its support's left edge is inside
        [66.6, 20.0, 1.0],      # → 67: wholly outside
        [30.0, 30.0, 0.0],      # invisible
        [63.0, 47.0, 2.0],      # visibility 2, at the corner
        [31.5, 0.5, 1.0],       # → (32, 0)
    ], np.float32)
    for h, w in ((64, 64), (48, 64)):
        want = jax_task.make_heatmaps(kp, h, w)
        got = port_task.make_heatmaps(kp, h, w)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum((0, 1)) == 0,
                                  [0, 0, 0, 1, 0, 1, 1, 0, 0])


def _heatmaps(kind, seed=0, b=3, h=16, w=12, k=6):
    rng = np.random.default_rng(seed)
    hm = rng.normal(0, 1, (b, h, w, k)).astype(np.float32)
    if kind == "ties":
        # a few levels: equal maxima at several cells, equal neighbours
        hm = rng.integers(0, 3, (b, h, w, k)).astype(np.float32)
    elif kind == "flat":
        hm[..., :3] = 0.0  # an invisible keypoint's all-zero channel
    elif kind == "border":
        hm = np.abs(hm) * 0.1
        for j, (y, x) in enumerate([(0, 0), (0, w - 1), (h - 1, 0),
                                    (h - 1, w - 1), (0, 5), (7, w - 1)]):
            hm[:, y, x, j] = 5.0
            if 0 < x < w - 1:
                hm[:, y, x + 1, j] = 1.0  # a larger right neighbour
    return hm


@pytest.mark.parametrize("kind", ["random", "ties", "flat", "border"])
@pytest.mark.parametrize("refine", [True, False])
def test_decode_heatmaps_matches_reference(kind, refine):
    hm = _heatmaps(kind)
    want = jax_task.decode_heatmaps(jnp.asarray(hm), refine=refine)
    got = port_task.decode_heatmaps(torch.from_numpy(hm), refine=refine)
    assert set(got) == set(want) == {"keypoints", "scores"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if not refine:
        for i in range(len(hm)):
            np.testing.assert_array_equal(
                got["keypoints"][i].numpy(), port_task.heatmap_argmax(hm[i]))
            np.testing.assert_array_equal(port_task.heatmap_argmax(hm[i]),
                                          jax_task.heatmap_argmax(hm[i]))


def test_pckh_matches_reference():
    rng = np.random.default_rng(1)
    true = rng.uniform(0, 64, (16, 2)).astype(np.float32)
    pred = true + rng.normal(0, 4, (16, 2)).astype(np.float32)
    vis = (rng.random(16) > 0.3).astype(np.float32)
    for head, alpha in ((10.0, 0.5), (3.0, 0.5), (6.0, 1.0)):
        assert port_task.pckh(pred, true, vis, head, alpha) == \
            jax_task.pckh(pred, true, vis, head, alpha)


def test_pose_task_loss_eval_and_gradients_match_reference():
    rng = np.random.default_rng(2)
    labels = np.stack([jax_task.make_heatmaps(
        np.concatenate([rng.uniform(0, 16, (KP, 2)),
                        (rng.random((KP, 1)) > 0.2)], 1), 16, 16)
        for _ in range(BATCH)]).astype(np.float32)
    outs = [rng.normal(0, 2, labels.shape).astype(np.float32)
            for _ in range(3)]
    weight = np.array([1, 1, 1, 0], np.float32)
    jt, pt = jax_task.PoseTask(), port_task.PoseTask()
    jb = {"heatmaps": jnp.asarray(labels), "weight": jnp.asarray(weight)}
    want_loss, want_aux = jt.loss(outs, jb)
    want_grads = jax.grad(lambda o: jt.loss(o, jb)[0])(
        [jnp.asarray(o) for o in outs])
    tb = {"heatmaps": torch.from_numpy(labels),
          "weight": torch.from_numpy(weight)}
    to = [torch.from_numpy(o).requires_grad_() for o in outs]
    loss, aux = pt.loss(to, tb)
    loss.backward()
    _close(float(loss.detach()), want_loss)
    _close(float(aux["mse_stacks"].detach()), want_aux["mse_stacks"])
    for s, (g, w) in enumerate(zip(to, want_grads)):
        _close(g.grad.numpy(), w, f"grad {s}")
    got_m = pt.eval_metrics([o.detach() for o in to], tb)
    want_m = jt.eval_metrics(outs, jb)
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        _close(float(got_m[k]), v, k)
    assert float(got_m["count"]) == 3.0
    # one output instead of a tuple: the single-stack form
    single, _ = pt.loss(torch.from_numpy(outs[0]), tb)
    _close(float(single), jt.loss(outs[0], jb)[0])


# -- the model and its converters ------------------------------------------------


HOURGLASSES = {
    # the hourglass_toy config: 4 stacks of order 2 at 16 filters
    "toy": dict(num_stack=4, num_heatmap=8, filters=16, order=2, size=64),
    # two stacks of order 1, two residuals: the residual chains and the
    # re-injection at another depth
    "two_residuals": dict(num_stack=2, num_heatmap=5, filters=8, order=1,
                          num_residual=2, size=32),
}


def _pair(name, seed=4):
    kw = dict(HOURGLASSES[name])
    size = kw.pop("size")
    jm = JaxHourglass(dtype=jnp.float32, **kw)
    v = seeded_variables(jm, (size, size, 3), seed=seed)
    pm = StackedHourglass(**kw)
    convert.load_stacked_hourglass(pm, v)
    return jm, v, pm, size


@pytest.mark.parametrize("name", sorted(HOURGLASSES))
def test_stacked_hourglass_eval_matches_flax(name):
    jm, v, pm, size = _pair(name)
    x = np.random.RandomState(5).rand(2, size, size, 3).astype(np.float32)
    ref = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert len(got) == len(ref) == pm.num_stack
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        assert g.shape == (2, size // 4, size // 4, pm.num_heatmap)
        _close(g.numpy(), r)


def test_stacked_hourglass_train_mode_matches_flax():
    jm, v, pm, size = _pair("toy")
    x = np.random.RandomState(6).rand(4, size, size, 3).astype(np.float32)
    ref, updates = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = pm.train()(torch.from_numpy(x))
    for r, g in zip(ref, got):
        _close(g.numpy(), r)
    want = convert.stacked_hourglass_from_flax(
        {"params": v["params"], "batch_stats": updates["batch_stats"]},
        4, 8, 16, 1, 2)
    sd = pm.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k].numpy(), w, k)


def test_converters_round_trip_and_strictness():
    _, v, pm, _ = _pair("toy")
    back = convert.flatten_tree(convert.stacked_hourglass_to_flax(
        pm.state_dict(), 4, 8, 16, 1, 2))
    want = convert.flatten_tree(v)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    # the last stack has no re-injection convs: 1 stem conv, 4 a stack
    # but the last, which has 2 (Conv_13, Conv_14)
    assert "params/Conv_12/kernel" in want
    assert "params/Conv_14/kernel" in want
    assert "params/Conv_15/kernel" not in want
    extra = convert.unflatten_tree(dict(want, **{
        "params/Conv_15/kernel": np.zeros((1, 1, 16, 16), np.float32)}))
    with pytest.raises(KeyError, match="Conv_15"):
        convert.load_stacked_hourglass(get_config("hourglass_toy").model(),
                                       extra)
    missing = convert.unflatten_tree(
        {k: a for k, a in want.items() if "HourglassModule_3" not in k})
    with pytest.raises(KeyError, match="HourglassModule_3"):
        convert.load_stacked_hourglass(get_config("hourglass_toy").model(),
                                       missing)


def test_configs_and_reset_parameters():
    toy, full = get_config("hourglass_toy"), get_config("hourglass104")
    m = toy.model()
    assert (m.num_stack, m.num_heatmap, m.filters, m.order) == (4, 8, 16, 2)
    assert (toy.task, toy.image_size, toy.num_classes, toy.batch_size) == \
        ("pose", 64, 8, 16)
    assert (full.image_size, full.num_classes, full.batch_size,
            full.optimizer.learning_rate) == (256, 16, 32, 1e-3)
    assert full.scheduler.name == "plateau" and full.scheduler.kwargs == \
        dict(mode="max", factor=0.1, patience=5)
    big = full.model()
    assert (big.num_stack, big.num_heatmap, big.filters, big.order) == \
        (4, 16, 256, 4)
    assert big.compute_dtype == torch.bfloat16
    a = m.reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    b = toy.model().reset_parameters(
        torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for mod in m.modules():
        if isinstance(mod, BatchNorm2d):
            assert torch.all(mod.weight == 1.0)
            assert torch.all(mod.running_var == 1.0)
    assert all(torch.all(p == 0) for k, p in a.items()
               if k.endswith(".bias") and "bn" not in k)
    # LeCun over fan-in for the re-injection of the 8 heatmaps
    # (truncated: std ≈ sqrt(1/8)); He over fan-out for the heatmap conv
    # (std sqrt(2/8) = 0.5)
    lecun = torch.cat([s.reinject_heat.weight.detach().flatten()
                       for s in m.stacks[:-1]])
    he = torch.cat([s.heat.weight.detach().flatten() for s in m.stacks])
    assert 0.25 < float(lecun.std()) < 0.45
    assert 0.4 < float(he.std()) < 0.6
    assert m.stacks[-1].reinject_heat is None


# -- input pipeline --------------------------------------------------------------


def test_crop_flip_and_synthetic_match_reference():
    assert port_data.MPII_NUM_KEYPOINTS == jax_data.MPII_NUM_KEYPOINTS
    assert port_data.MPII_FLIP_PAIRS == jax_data.MPII_FLIP_PAIRS
    want = jax_data.synthetic_pose_dataset(4, SIZE, KP, seed=4)
    got = port_data.synthetic_pose_dataset(4, SIZE, KP, seed=4)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    img = want[0]["image"]
    kp = want[0]["keypoints"].copy()
    for case in ("as is", "none visible", "absent"):
        if case == "none visible":
            kp[:, 2] = 0.0
        if case == "absent":
            kp[:3, 0] = -1.0
            kp[:, 2] = 1.0
        gc, gk = port_data.crop_roi(img, kp, 0.1)
        wc, wk = jax_data.crop_roi(img, kp, 0.1)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gk, wk)


def _poses(n=10, seed=0):
    return jax_data.synthetic_pose_dataset(n, SIZE, KP, seed=seed)


def _loader(mod, samples, train, **kw):
    return mod.PoseLoader(samples, BATCH, SIZE, SIZE // 4, KP, train=train,
                          seed=SEED, device_normalize=True, **kw)


@pytest.mark.parametrize("train", [True, False])
def test_loader_matches_reference(train):
    samples = _poses()
    # one crop already at the input size (a margin past every edge): no
    # resize on either side
    samples[0] = dict(samples[0], scale=10.0)
    want, got = _loader(jax_data, samples, train), \
        _loader(port_data, samples, train)
    exact = 0
    for epoch in (1, 2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        w_batches, g_batches = list(want), list(got)
        assert len(g_batches) == len(w_batches) == (2 if train else 3)
        for g, w in zip(g_batches, w_batches):
            assert set(g) == set(w)
            for k in w:
                if k != "image":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["image"].dtype == np.uint8
            diff = np.abs(g["image"].astype(int) - w["image"].astype(int))
            assert diff.max() <= 1
            exact += int((diff.reshape(BATCH, -1).max(1) == 0).sum())
    assert exact > 0


def test_pooled_batches_equal_inline():
    samples = _poses(12, seed=5)
    inline = _loader(port_data, samples, True)
    pooled = _loader(port_data, samples, True, num_workers=2)
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


def test_raw_pose_records_match_reference(tmp_path):
    at_size = _poses(3, seed=6)
    rng = np.random.default_rng(7)
    # larger images, rescaled on write: the longer side rounds, so the
    # keypoints scale per axis
    rescaled = [dict(s, image=rng.integers(0, 256, shape, dtype=np.uint8),
                     keypoints=s["keypoints"] * [shape[1] / SIZE,
                                                 shape[0] / SIZE, 1.0])
                for s, shape in zip(_poses(2, seed=8),
                                    ((101, 77, 3), (90, 131, 3)))]
    for i, sample in enumerate(at_size + rescaled):
        gh, gp = port_records.encode_pose_sample(sample, "raw", SIZE)
        wh, wp = jax_records.encode_pose_sample(sample, "raw", SIZE)
        assert json.dumps(gh) == json.dumps(wh)
        assert gh["enc"] == "raw" and min(gh["shape"][:2]) == SIZE
        g = np.frombuffer(gp, np.uint8).astype(int)
        w = np.frombuffer(wp, np.uint8).astype(int)
        assert g.shape == w.shape
        if i < len(at_size):
            assert gp == wp
        else:
            assert np.abs(g - w).max() <= 1
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    port_records.write_pose_records(at_size, mine, "train", 2,
                                    num_workers=1, resize=SIZE)
    jax_records.write_pose_records(at_size, ref, "train", 2, num_workers=1,
                                   store="raw", resize=SIZE)
    for a, b in zip(port_records.list_shards(mine, "train"),
                    jax_records.list_shards(ref, "train")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()  # byte for byte
    got = port_records.load_pose_records(mine, "train")
    want = jax_records.load_pose_records(ref, "train")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("image", "keypoints", "center"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["scale"] == w["scale"]
    with pytest.raises(NotImplementedError, match="raw"):
        port_records.write_pose_records(at_size, mine, "val", 1,
                                        num_workers=1, store="jpeg")
    jpeg = str(tmp_path / "jpeg")
    jax_records.write_pose_records(at_size[:2], jpeg, "val", 1,
                                   num_workers=1, store="jpeg")
    with pytest.raises(ValueError, match="JPEG payload"):
        port_records.load_pose_records(jpeg, "val")


# -- cli.train and the profiler on the CPU -------------------------------------


def test_cli_train_hourglass_toy_on_cpu_with_resume(tmp_path, capsys):
    from deep_vision_tpu_torch.cli import train as cli

    work = tmp_path / "work"
    argv = ["-m", "hourglass_toy", "--synthetic", "--synthetic-size", "32",
            "--workdir", str(work), "--device", "cpu"]
    assert cli.main(argv + ["--epochs", "1"]) == 0
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step=2 start_epoch=2" in out
    assert "final: loss=" in out and "neg_loss=" in out
    assert sorted(os.listdir(work / "checkpoints")) == ["2", "4"]
    assert os.listdir(work / "checkpoints_best")  # monitored on neg_loss
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    losses = [d for d in lines if d["name"] == "train_loss"]
    assert [d["step"] for d in losses] == [2, 4]
    assert all(np.isfinite(d["value"]) for d in losses)
    assert {"val_loss", "val_neg_loss", "train_mse_stacks"} <= \
        {d["name"] for d in lines}


def test_profile_pose_train_step_on_cpu(capsys):
    from deep_vision_tpu_torch.obs import profile

    assert profile.main(["-m", "hourglass_toy", "--train", "--device",
                         "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batch"] == 16 and rep["wall_ms_per_step"] > 0
    assert rep["device_busy_ms_per_step"] is None  # no device on the CPU

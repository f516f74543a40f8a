"""The port's YOLOv3 training input and optimizer (deep_vision_tpu_torch:
data/detection.py, data/loader.py PreppedSampleLoader, data/records.py
detection records, core/optim.py clip + Adam, cli/train.py's detection
branch, obs/profile.py) against the JAX reference, on the CPU.

Tolerances, each with its reason:

- Loader batches: ``y_true_*``, ``boxes``, ``boxes_mask``,
  ``gt_classes`` and ``weight`` exact (the same numpy code and draws);
  ``image`` exact on every item that took no resize, and within 1 grey
  level on the crop-resized ones: the port resizes with torch's bilinear
  (no cv2 or PIL on the card machine), the reference with cv2's
  ``INTER_LINEAR``.
- clip + Adam against the reference's optax chain
  (``clip_by_global_norm`` then ``adam``/``adamw``) on the same gradients
  for 5 steps, one with the clip active and one skipped by the guard:
  parameters, ``mu`` and ``nu`` within 1e-6 of each tensor's largest
  magnitude, the count exact.
"""

import os

import numpy as np
import pytest
import torch

import jax

import _torch_port  # noqa: F401  (two intra-op threads)
from deep_vision_tpu.core import optim as jax_optim
from deep_vision_tpu.data import detection as jax_data
from deep_vision_tpu.data import records as jax_records
from deep_vision_tpu_torch.core import optim as port_optim
from deep_vision_tpu_torch.data import detection as port_data
from deep_vision_tpu_torch.data import records as port_records

SIZE, BATCH, SEED = 64, 4, 3


def _samples(n=10, seed=0):
    return jax_data.synthetic_detection_dataset(n, SIZE, 3, seed=seed)


def test_synthetic_scenes_match_reference():
    want = _samples(6, seed=4)
    got = port_data.synthetic_detection_dataset(6, SIZE, 3, seed=4)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _cropped(samples, i, epoch):
    """Whether item ``i`` took the crop (and so the resize) this epoch:
    the loader's own draws, replayed."""
    rng = np.random.default_rng((SEED, epoch, i))
    if not len(samples[i]["boxes"]):
        return False
    rng.random()  # the flip
    return rng.random() < 0.5


@pytest.mark.parametrize("train", [True, False])
def test_loader_matches_reference(train):
    samples = _samples()
    kw = dict(train=train, seed=SEED, device_normalize=True)
    want = jax_data.DetectionLoader(samples, BATCH, 3, SIZE, **kw)
    got = port_data.DetectionLoader(samples, BATCH, 3, SIZE, **kw)
    resized = exact = 0
    for epoch in (1, 2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        order = np.arange(len(samples))
        if train:
            np.random.default_rng((SEED, epoch)).shuffle(order)
        w_batches, g_batches = list(want), list(got)
        assert len(g_batches) == len(w_batches) == len(got) == \
            (2 if train else 3)
        for b, (g, w) in enumerate(zip(g_batches, w_batches)):
            assert set(g) == set(w)
            for k in w:
                if k != "image":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["image"].dtype == np.uint8
            for j, i in enumerate(order[b * BATCH:(b + 1) * BATCH]):
                diff = np.abs(g["image"][j].astype(int)
                              - w["image"][j].astype(int))
                if train and _cropped(samples, i, epoch):
                    assert diff.max() <= 1
                    resized += 1
                else:
                    assert diff.max() == 0
                    exact += 1
    assert exact > 0 and (resized > 0 or not train)


def test_pooled_batches_equal_inline():
    samples = _samples(12, seed=5)
    inline = port_data.DetectionLoader(samples, BATCH, 3, SIZE, seed=SEED,
                                       device_normalize=True)
    pooled = port_data.DetectionLoader(samples, BATCH, 3, SIZE, seed=SEED,
                                       device_normalize=True, num_workers=2)
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


def test_detection_records_shared_with_reference(tmp_path):
    samples = _samples(7, seed=6)
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    port_records.write_detection_records(samples, mine, "train", 2,
                                         num_workers=1, store="raw",
                                         resize=SIZE)
    jax_records.write_detection_records(samples, ref, "train", 2,
                                        num_workers=1, store="raw",
                                        resize=SIZE)
    for a, b in zip(port_records.list_shards(mine, "train"),
                    jax_records.list_shards(ref, "train")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()  # byte for byte
    for root in (mine, ref):
        got = port_records.load_detection_records(root, "train")
        want = jax_records.load_detection_records(root, "train")
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            for k in ("image", "boxes", "classes"):
                np.testing.assert_array_equal(g[k], w[k])
    # a 100×80 image is square-resized on write, as the reference does
    big = dict(samples[0], image=np.zeros((100, 80, 3), np.uint8))
    header, payload = port_records.encode_detection_sample(
        big, store="raw", resize=SIZE)
    assert header["shape"] == [SIZE, SIZE, 3] and header["enc"] == "raw"
    assert len(payload) == SIZE * SIZE * 3
    # JPEG payloads decode as the reference decodes them
    jpeg = str(tmp_path / "jpeg")
    jax_records.write_detection_records(samples[:2], jpeg, "val", 1,
                                        num_workers=1, store="jpeg")
    got = port_records.load_detection_records(jpeg, "val")
    want = jax_records.load_detection_records(jpeg, "val")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("image", "boxes", "classes"):
            np.testing.assert_array_equal(g[k], w[k])


# -- clip + Adam against optax -------------------------------------------------


class _Tiny(torch.nn.Module):
    """A dense layer and a BatchNorm: kernels decay, scales and biases do
    not (the reference's mask)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(5, 3)
        self.bn = torch.nn.BatchNorm1d(3)


#: port parameter ↔ flax leaf (the dense kernel is the transpose)
FLAX = {"fc.weight": ("Dense_0", "kernel"), "fc.bias": ("Dense_0", "bias"),
        "bn.weight": ("BatchNorm_0", "scale"),
        "bn.bias": ("BatchNorm_0", "bias")}


def _to_flax(named):
    tree = {}
    for name, (mod, leaf) in FLAX.items():
        v = np.array(named[name], np.float32)  # a copy: torch updates
        tree.setdefault(mod, {})[leaf] = v.T if leaf == "kernel" else v
    return tree


def _from_flax(tree):
    out = {}
    for name, (mod, leaf) in FLAX.items():
        v = np.asarray(tree[mod][leaf])
        out[name] = v.T if leaf == "kernel" else v
    return out


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the injected-hyperparams chain."""
    if type(opt_state).__name__ == "ScaleByAdamState":
        return opt_state
    children = opt_state if isinstance(opt_state, (tuple, list)) else \
        [getattr(opt_state, "inner_state", None)]
    for c in children:
        found = _adam_state(c) if c is not None else None
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_clip_adam_matches_optax(weight_decay):
    model = _Tiny()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 1, p.shape)
                                     .astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]
    kw = dict(name="adam", learning_rate=1e-2, grad_clip_norm=10.0,
              weight_decay=weight_decay)
    opt = port_optim.build_optimizer(port_optim.OptimizerConfig(**kw), model)
    assert isinstance(opt, port_optim.Adam)
    tx = jax_optim.build_optimizer(jax_optim.OptimizerConfig(**kw))
    params = _to_flax({n: p.detach().numpy()
                       for n, p in model.named_parameters()})
    state = tx.init(params)
    applied = 0
    # step 2: gradients ×100 (global norm > 10: the clip acts); step 3:
    # a skipped step (the guard's ok is false)
    for step in range(5):
        grads = {n: rng.normal(0, 1, p.shape).astype(np.float32)
                 * (100.0 if step == 2 else 1.0)
                 for n, p in model.named_parameters()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads.values()))
        assert (norm > 10.0) == (step == 2)
        ok = step != 3
        opt.step([torch.from_numpy(grads[n]) for n in names],
                 torch.tensor(ok))
        if ok:
            updates, state = tx.update(_to_flax(grads), state, params)
            params = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(
                lambda p, u: p + u, params, updates))
            applied += 1
        adam = _adam_state(state)
        assert int(opt.count) == int(adam.count) == applied
        want = {"params": _from_flax(params), "mu": _from_flax(adam.mu),
                "nu": _from_flax(adam.nu)}
        got = {"params": dict(model.named_parameters()),
               "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu))}
        for part in want:
            for n in names:
                w, g = want[part][n], got[part][n].detach().numpy()
                assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), \
                    (step, part, n)
    sd = opt.state_dict()
    fresh = port_optim.build_optimizer(port_optim.OptimizerConfig(**kw),
                                       model)
    fresh.load_state_dict(sd)
    assert int(fresh.count) == applied
    assert all(torch.equal(a, b) for a, b in zip(fresh.nu, opt.nu))


def test_clip_by_global_norm_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    same = port_optim.clip_by_global_norm(g, 10.0)   # norm 5 < 10: as is
    assert all(torch.equal(a, b) for a, b in zip(same, g))
    cut = port_optim.clip_by_global_norm(g, 2.5)     # g / 5 · 2.5
    assert torch.equal(cut[0], torch.tensor([3.0, 4.0]) / 5.0 * 2.5)
    # nesterov builds (tests/test_torch_optim_recipes.py holds it against
    # optax); a bfloat16 momentum is SGD's only, as in the reference
    assert port_optim.build_optimizer(
        port_optim.OptimizerConfig(nesterov=True), _Tiny()).cfg.nesterov
    with pytest.raises(ValueError, match="momentum_dtype applies"):
        port_optim.build_optimizer(
            port_optim.OptimizerConfig(name="adam",
                                       momentum_dtype="bfloat16"), _Tiny())


# -- cli.train and the profiler on the CPU -------------------------------------


def test_cli_train_yolov3_toy_on_cpu_with_resume(tmp_path, capsys):
    """cli.train -m yolov3_toy on raw records written by the port: one
    epoch of 2 steps with a checkpoint, then a resumed second epoch."""
    import json

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer

    data, work = str(tmp_path / "data"), tmp_path / "work"
    port_records.write_detection_records(_samples(16, seed=8), data,
                                         "train", 2, num_workers=1,
                                         store="raw", resize=SIZE)
    port_records.write_detection_records(_samples(6, seed=9), data, "val",
                                         1, num_workers=1, store="raw",
                                         resize=SIZE)
    argv = ["-m", "yolov3_toy", "--data-root", data, "--workdir",
            str(work), "--num-workers", "0", "--device", "cpu"]
    assert cli.main(argv + ["--epochs", "1"]) == 0
    saved = Checkpointer(str(work / "checkpoints")).load(2)["state"]
    assert int(saved["optimizer"]["count"]) == 2
    assert set(saved["optimizer"]) == {"mu", "nu", "count", "learning_rate"}
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step=2 start_epoch=2" in out
    assert "final: loss=" in out and "mAP=" in out
    assert sorted(os.listdir(work / "checkpoints")) == ["2", "4"]
    assert os.listdir(work / "checkpoints_best")  # monitored on mAP
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    # yolov3_toy logs every 10 steps, and each epoch's last step
    losses = [d for d in lines if d["name"] == "train_loss"]
    assert [d["step"] for d in losses] == [2, 4]
    assert all(np.isfinite(d["value"]) for d in losses)
    names = {d["name"] for d in lines}
    assert {"val_mAP", "val_mAP50_95", "val_loss", "train_ignored_0",
            "train_obj_2", "train_step_ms"} <= names


def test_cli_refuses_centernet(tmp_path, monkeypatch):
    """``-m centernet`` trains on the card: without a GPU and without
    ``--device cpu`` it is refused before any work; a task that is not
    ported is refused naming the ported ones."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core import config as port_config
    from deep_vision_tpu_torch.models.yolo import YoloV3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-m", "centernet", "--synthetic", "--workdir",
                  str(tmp_path)])
    assert not os.listdir(tmp_path)
    port_config.register_config("torch_port_unported_stub")(
        lambda: port_config.TrainConfig(
            name="torch_port_unported_stub", model=lambda: YoloV3(3),
            task="segmentation"))
    with pytest.raises(NotImplementedError, match="centernet"):
        cli.main(["-m", "torch_port_unported_stub", "--synthetic",
                  "--workdir", str(tmp_path), "--device", "cpu"])


def test_profile_yolo_train_step_on_cpu(capsys):
    import json

    from deep_vision_tpu_torch.obs import profile

    assert profile.main(["-m", "yolov3_toy", "--train", "--device",
                         "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batch"] == 8 and rep["wall_ms_per_step"] > 0
    assert rep["device_busy_ms_per_step"] is None  # no device on the CPU
    assert profile.kernel_group(
        "(anonymous namespace)::best_iou_max_kernel(...)") == "best_iou_max"

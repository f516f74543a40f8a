"""Multi-step dispatch (``scan_steps``) of both trainers on the CPU, and
the adversarial trainer's ``sample_hook`` and refusals.

On the CPU the steps of a group run eagerly through the same
``StepRunner`` that captures and replays them as a CUDA graph on the
card (``core/step_graph.py``; ``chip_smoke.py`` holds the graph against
single steps there): the grouping, the once-a-group metric read, the
guard over every step and the ragged tail are what is held here.

- ``scan_steps`` 3 over 7 batches (two groups and a ragged tail of one)
  against ``scan_steps`` 1: the same steps in the same order on one
  device, so the weights are equal bit for bit and so is every logged
  loss.
- Against the JAX Trainer's scan run (``lax.scan`` over the group) at
  the same weights and batches: the logged losses within 1e-5 relative
  and the update within 1e-5 of its L2 norm (float32 rounding of two
  frameworks over 7 SGD steps; measured 1e-6 and below).
"""

import tempfile

import numpy as np
import pytest
import torch

import jax

import _torch_recipes as tr
from deep_vision_tpu.data.loader import ArrayLoader as JaxArrayLoader
from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.step_graph import (
    StepRunner,
    _culprit,
    run_groups,
)
from deep_vision_tpu_torch.data import gan as gan_data
from deep_vision_tpu_torch.data.loader import ArrayLoader
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.ops.preprocess import make_gan_preprocess
from deep_vision_tpu_torch.ops.train_ingest import train_ingest
from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask

N_BATCHES, BATCH, K = 7, 16, 3


def _arrays(seed=0, nan_batch=None):
    data = tr.batches(N_BATCHES, BATCH, seed=seed)
    if nan_batch is not None:
        data[nan_batch]["image"][:] = np.nan
    return {k: np.concatenate([b[k] for b in data]) for k in data[0]}


def _port_fit(scan, arrays, **kw):
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, tr.lenet_variables(),
                                         scan=scan, **kw)
        state = trainer.fit(ArrayLoader(arrays, BATCH, shuffle=False),
                            state=state)
        return trainer, state


def _losses(logger) -> dict:
    s = logger.history["train_loss"]
    return dict(zip(s["steps"], s["values"]))


def test_scan_groups_equal_single_steps():
    arrays = _arrays()
    t1, s1 = _port_fit(1, arrays)
    tk, sk = _port_fit(K, arrays)
    assert s1.step == sk.step == N_BATCHES == int(sk.device_step)
    for a, b in zip(s1.opt.params, sk.opt.params):
        assert torch.equal(a, b)
    for a, b in zip(s1.opt.momentum, sk.opt.momentum):
        assert torch.equal(a, b)
    runner = tk._runner
    assert runner.eager_steps == 2 * K and runner.replays == 0
    assert runner.graph is None  # no graphs on the CPU
    # once a group (its last step) and each tail step
    got, want = _losses(tk.logger), _losses(t1.logger)
    assert sorted(got) == [K, 2 * K, N_BATCHES]
    assert all(got[s] == want[s] for s in got)


def test_guard_sees_a_nan_in_the_middle_of_a_group(capsys):
    arrays = _arrays(nan_batch=4)  # step 5: the middle of group 2
    trainer, state = _port_fit(K, arrays)
    assert int(state.bad_steps) == 1 and state.step == N_BATCHES
    assert "skipped 1 non-finite step" in capsys.readouterr().out
    bad = trainer.logger.history["train_bad_steps"]
    assert dict(zip(bad["steps"], bad["values"]))[2 * K] == 1
    # the guard's limit reads every step of the group
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, tr.lenet_variables(), scan=K)
        trainer.guard.limit = 0
        with pytest.raises(RuntimeError, match="training diverged"):
            trainer.fit(ArrayLoader(arrays, BATCH, shuffle=False),
                        state=state)


def test_jax_trainer_scan_run_has_the_same_losses():
    variables = tr.lenet_variables()
    arrays = _arrays(seed=2)
    trainer, state = _port_fit(K, arrays)
    with tempfile.TemporaryDirectory() as work:
        jtrainer, jstate = tr.jax_trainer(work, variables, scan=K)
        jstate = jtrainer.fit(JaxArrayLoader(arrays, BATCH, shuffle=False),
                              state=jstate)
        want = _losses(jtrainer.logger)
        jparams = jax.device_get(jstate.params)
    got = _losses(trainer.logger)
    assert sorted(got) == sorted(want) == [K, 2 * K, N_BATCHES]
    for s, v in want.items():
        assert abs(got[s] - v) <= 1e-5 * abs(v), (s, got[s], v)
    init = tr.to_port({"params": variables["params"]})
    ref = tr.to_port({"params": jparams})
    port = tr.numpy_sd(state.model)
    assert tr.rel_l2({k: port[k] - init[k] for k in port},
                     {k: ref[k] - init[k] for k in ref}) <= 1e-5


def _dcgan(scan, work, n=40):
    cfg = get_config("dcgan")
    cfg.batch_size, cfg.scan_steps, cfg.log_every_steps = 8, scan, 1
    images = gan_data.mnist_gan_data(None, n_synthetic=n,
                                     device_normalize=True)
    loader = gan_data.GANLoader(images, cfg.batch_size, seed=cfg.seed)
    trainer = AdversarialTrainer(
        cfg, DCGANTask(gan.DCGANGenerator, gan.DCGANDiscriminator,
                       opt=cfg.optimizer),
        workdir=work, preprocess_fn=make_gan_preprocess(), device="cpu")
    return trainer, loader


def _weights(states):
    return {f"{n}/{k}": v.clone() for n, st in states.items()
            for k, v in st.model.state_dict().items()}


def test_dcgan_scan_two_equals_one(tmp_path):
    """5 steps an epoch: two groups of 2 and a tail of 1."""
    runs = {}
    for scan in (1, 2):
        trainer, loader = _dcgan(scan, str(tmp_path / f"k{scan}"))
        states = trainer.fit(loader, epochs=1)
        runs[scan] = _weights(states)
        assert all(st.step == 5 and int(st.bad_steps) == 0
                   for st in states.values())
        if scan == 2:
            assert trainer._runner is not None
            assert trainer._runner.eager_steps == 4
            logged = trainer.logger.history["g_loss"]["steps"]
            assert logged == [2, 4, 5]
    assert runs[1].keys() == runs[2].keys()
    assert all(torch.equal(runs[1][k], runs[2][k]) for k in runs[1])


def test_cyclegan_runs_per_step_with_scan_steps(tmp_path):
    cfg = get_config("cyclegan")
    a, b = gan_data.synthetic_unpaired(3, 32, device_normalize=True)
    runs = {}
    for scan in (1, 4):
        cfg.scan_steps = scan
        trainer = AdversarialTrainer(
            cfg, CycleGANTask(lambda: gan.CycleGANGenerator(2),
                              gan.PatchGANDiscriminator),
            workdir=str(tmp_path / f"k{scan}"),
            preprocess_fn=make_gan_preprocess(), device="cpu")
        assert not trainer.task.scan_safe
        states = trainer.fit(gan_data.UnpairedLoader(a, b, 1, seed=cfg.seed),
                             epochs=1)
        assert trainer._runner is None  # never grouped
        assert len(trainer.task.pool_a2b.pool) == 2
        runs[scan] = _weights(states)
    assert all(torch.equal(runs[1][k], runs[4][k]) for k in runs[1])


def test_sample_hook_runs_once_an_epoch_after_the_checkpoint(tmp_path):
    trainer, loader = _dcgan(2, str(tmp_path))
    seen = []

    def hook(epoch, states):
        seen.append((epoch, trainer.checkpointer.latest_step(),
                     sorted(states), next(iter(states.values())).step))
    states = trainer.fit(loader, epochs=2, sample_hook=hook)
    # dcgan checkpoints every 2 epochs: none after epoch 1
    assert seen == [(1, None, ["discriminator", "generator"], 5),
                    (2, 10, ["discriminator", "generator"], 10)]
    assert all(st.step == 10 for st in states.values())


def test_adversarial_trainer_refuses_ema_decay(tmp_path):
    """A departure from the reference, which accepts ``ema_decay`` in the
    adversarial trainer and ignores it: the port refuses it."""
    cfg = get_config("dcgan")
    cfg.ema_decay = 0.999
    with pytest.raises(NotImplementedError, match="ema_decay"):
        AdversarialTrainer(cfg, DCGANTask(gan.DCGANGenerator,
                                          gan.DCGANDiscriminator),
                           workdir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("field", ["scan_steps", "grad_accum_steps"])
def test_counts_below_one_are_refused(field, tmp_path):
    cfg = get_config("lenet5")
    setattr(cfg, field, 0)
    with pytest.raises(ValueError, match=field):
        tr.Trainer(cfg, cfg.model(), None, workdir=str(tmp_path),
                   device="cpu")


def test_step_runner_groups_metrics_on_the_cpu():
    calls = []

    def step(batch):
        calls.append(batch["x"])
        return {"loss": batch["x"].sum(), "bad_steps": torch.tensor(0)}

    runner = StepRunner(step, [], torch.device("cpu"), group=3)
    for g in range(2):
        for j in range(3 if g == 0 else 2):
            runner.step({"x": torch.full((2,), float(3 * g + j))})
        assert runner.keys == ["loss", "bad_steps"]
        want = [{"loss": 2.0 * (3 * g + j), "bad_steps": 0.0}
                for j in range(3 if g == 0 else 2)]
        assert runner.read_group() == want
    assert runner.eager_steps == 5 and len(calls) == 5


def test_run_groups_leaves_the_ragged_tail():
    """7 batches in groups of 3: two groups, each read once after its
    last step, seeded before and advanced after every step; the seventh
    batch comes back as the tail.  A stop ends the loop after a group."""
    events = []
    runner = StepRunner(lambda b: {"loss": b["x"].sum()}, [],
                        torch.device("cpu"), group=3)
    batches = [{"x": torch.tensor([float(i)])} for i in range(7)]
    tail = run_groups(batches, runner, lambda: events.append("seed"),
                      lambda: events.append("advance"),
                      lambda b: events.append(int(b["x"])),
                      lambda steps: events.append(
                          [m["loss"] for m in steps]),
                      lambda: False)
    def step(i):
        return ["seed", "advance", i]

    assert events == (step(0) + step(1) + step(2) + [[0.0, 1.0, 2.0]]
                      + step(3) + step(4) + step(5) + [[3.0, 4.0, 5.0]])
    assert [int(b["x"]) for b in tail] == [6]
    groups = []
    tail = run_groups(batches, runner, lambda: None, lambda: None,
                      lambda b: None, groups.append, lambda: True)
    assert len(groups) == 1 and tail == []


def test_every_counting_wrapper_is_registered():
    """A captured step counts the launches of the wrappers in
    ``ops.COUNTED``: every wrapper that keeps a launch counter."""
    from deep_vision_tpu_torch.ops import COUNTED
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    assert {f.__name__ for f in COUNTED} == {
        "serve_ingest", "train_ingest", "best_iou_max"}
    assert all(isinstance(f.launches, int) for f in COUNTED)
    assert {train_ingest, best_iou_max, serve_ingest} <= set(COUNTED)


def test_capture_failure_names_the_code():
    """What a failed capture reports: the innermost frame of the port."""
    try:
        train_ingest(torch.zeros((1, 4, 4, 3)), torch.zeros((1, 4)))
    except TypeError as e:
        where = _culprit(e)
    assert where.startswith("deep_vision_tpu_torch/ops/train_ingest.py:")
    assert "raise TypeError" in where

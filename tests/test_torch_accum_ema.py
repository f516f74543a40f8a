"""Gradient accumulation (``grad_accum_steps``) and the params EMA
(``ema_decay``) of the port's Trainer against the JAX ``Trainer``
(reference tests/test_grad_accum.py and tests/test_ema.py), on the CPU
at float32 from the same seeded weights and numpy batches
(``_torch_recipes``).

Tolerances, each with its reason:

- Accumulated steps against the JAX Trainer's (LeNet-5, SGD, two
  steps): losses within 1e-5 relative, the parameters' update within
  1e-5 of its L2 norm over the model.  The two frameworks sum and
  average the microbatch gradients in other orders; an SGD step carries
  that rounding (measured 1.2e-6 at A = 2 and 4).
- BN-free, the port's A microbatches against its own full-batch step:
  parameters within 1e-6 relative in L2 (the mean of the microbatch
  means is the full-batch mean up to float32 rounding), and the loss
  within 1e-6.
- With BatchNorm (a one-block ResNet, A = 2): running statistics and
  parameters against the JAX Trainer's within 1e-6 of their L2 norms
  (measured 9e-8 and 1.5e-8).  The reference's microbatches are
  interleaved; a contiguous split normalizes other rows together and
  must miss the bound (it reads 4e-3 and 9e-3).
- The EMA after 5 steps against the JAX Trainer's: within 1e-6 of its
  L2 norm (measured 4.6e-8: the trajectories part by float32 rounding
  only); the guard's NaN step against the host replay of the EMA's
  formula within 1e-6 relative (one product and one sum a step).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax

import _torch_recipes as tr
from deep_vision_tpu.cli.infer import _load_state as jax_load_state
from deep_vision_tpu.data.loader import ArrayLoader as JaxArrayLoader
from deep_vision_tpu_torch.core import trainer as trainer_module
from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import (
    EMA_WEIGHTS,
    RAW_WEIGHTS,
    load_state,
    params_digest,
)
from deep_vision_tpu_torch.core.state import ema_decay_at
from deep_vision_tpu_torch.data.loader import ArrayLoader
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.tasks.gan import DCGANTask


def _port_steps(variables, data, bn=False, **kw):
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, variables, bn, **kw)
        metrics = []
        for b in data:
            state, m = trainer.train_step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, state


# -- gradient accumulation ----------------------------------------------------


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_steps_match_jax_trainer(accum):
    variables = tr.lenet_variables()
    data = tr.batches(2, 16)
    want_m, want_state = tr.jax_steps(variables, data, accum=accum)
    got_m, state = _port_steps(variables, data, accum=accum)
    for g, w in zip(got_m, want_m):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
        assert g["bad_steps"] == w["bad_steps"] == 0
    init = tr.to_port({"params": variables["params"]})
    want = tr.to_port({"params": want_state.params})
    got = tr.numpy_sd(state.model)
    update = {k: want[k] - init[k] for k in want}
    assert tr.rel_l2({k: got[k] - init[k] for k in got}, update) <= 1e-5


def test_accumulation_is_the_full_batch_step_without_bn():
    variables = tr.lenet_variables()
    data = tr.batches(1, 32)
    full_m, full = _port_steps(variables, data)
    acc_m, acc = _port_steps(variables, data, accum=4)
    assert abs(acc_m[0]["loss"] - full_m[0]["loss"]) \
        <= 1e-6 * abs(full_m[0]["loss"])
    assert tr.rel_l2(tr.numpy_sd(acc.model), tr.numpy_sd(full.model)) <= 1e-6
    assert not all(np.array_equal(a, b) for a, b in zip(
        tr.numpy_sd(acc.model).values(),
        tr.numpy_sd(tr.port_model(variables)).values()))


def _bn_errors(variables, data, want_state, split=None):
    """(parameters, running statistics) of the port's accumulated BN step
    against the JAX Trainer's, relative in L2."""
    stats = ("running_mean", "running_var")
    if split is not None:
        orig = trainer_module.interleaved_split
        trainer_module.interleaved_split = split
    try:
        _, state = _port_steps(variables, data, bn=True, accum=2)
    finally:
        if split is not None:
            trainer_module.interleaved_split = orig
    got = tr.numpy_sd(state.model)
    want = tr.to_port({"params": want_state.params,
                       "batch_stats": want_state.batch_stats}, bn=True)
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    return (tr.rel_l2(got, want, [k for k in keys if not k.endswith(stats)]),
            tr.rel_l2(got, want, [k for k in keys if k.endswith(stats)]))


def test_batchnorm_threads_through_the_microbatches():
    """Two running-statistic updates a step, on the interleaved
    microbatches, as the JAX Trainer's; a contiguous split misses."""
    variables = tr.bn_variables()
    data = tr.batches(1, 8, bn=True)
    _, want_state = tr.jax_steps(variables, data, bn=True, accum=2)
    params, stats = _bn_errors(variables, data, want_state)
    assert params <= 1e-6 and stats <= 1e-6, (params, stats)
    # two training forwards a step reach every BatchNorm
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, variables, bn=True, accum=2)
        calls = []
        state.model.bn1.register_forward_hook(
            lambda mod, i, o: calls.append(mod.training))
        trainer.train_step(state, data[0])
        assert calls == [True, True]

    def contiguous(batch, parts):
        b = next(iter(batch.values())).shape[0] // parts
        return [{k: v[a * b:(a + 1) * b].contiguous()
                 for k, v in batch.items()} for a in range(parts)]

    c_params, c_stats = _bn_errors(variables, data, want_state, contiguous)
    assert c_params > 1e-6 and c_stats > 1e-6, (c_params, c_stats)


def test_indivisible_batch_raises():
    variables = tr.lenet_variables()
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, variables, accum=3)
        with pytest.raises(ValueError, match="grad_accum_steps"):
            trainer.train_step(state, tr.batches(1, 16)[0])


def test_adversarial_trainer_refuses_accumulation(tmp_path):
    cfg = get_config("dcgan")
    cfg.grad_accum_steps = 2
    with pytest.raises(NotImplementedError, match="grad_accum"):
        AdversarialTrainer(cfg, DCGANTask(gan.DCGANGenerator,
                                          gan.DCGANDiscriminator),
                           workdir=str(tmp_path), device="cpu")


def test_interleaved_split_is_the_references():
    batch = {"x": torch.arange(12).view(6, 2), "y": torch.arange(6)}
    parts = trainer_module.interleaved_split(batch, 3)
    assert [p["y"].tolist() for p in parts] == [[0, 3], [1, 4], [2, 5]]
    assert torch.equal(parts[1]["x"], batch["x"][1::3])


# -- the params EMA -----------------------------------------------------------


def test_ema_after_five_steps_matches_jax_trainer():
    variables = tr.lenet_variables()
    data = tr.batches(5, 16, seed=3)
    _, want_state = tr.jax_steps(variables, data, ema=0.9)
    _, state = _port_steps(variables, data, ema=0.9)
    want = tr.to_port({"params": want_state.ema_params})
    got = {n: e.detach().numpy() for n, e in state.ema_named().items()}
    assert tr.rel_l2(got, want) <= 1e-6
    raw = tr.to_port({"params": want_state.params})
    assert tr.rel_l2(got, raw) > 1e-3  # the EMA is not the weights


def test_nan_step_keeps_params_and_reaverages_ema():
    variables = tr.lenet_variables()
    good = tr.batches(2, 16, seed=4)
    bad = {"image": np.full_like(good[0]["image"], np.nan),
           "label": good[0]["label"]}
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, variables, ema=0.9)
        for b in good:
            state, _ = trainer.train_step(state, b)
        params = [p.detach().clone() for p in state.opt.params]
        ema = [e.clone() for e in state.ema]
        state, m = trainer.train_step(state, bad)
        assert int(m["bad_steps"]) == int(state.bad_steps) == 1
        assert state.step == 3 and int(state.device_step) == 3
        for p, old in zip(state.opt.params, params):
            assert torch.equal(p, old)
        d = float(ema_decay_at(0.9, torch.tensor(3)))
        assert d == pytest.approx(4 / 13)
        for e, old, p in zip(state.ema, ema, params):
            want = d * old + (1 - d) * p
            assert torch.allclose(e, want, rtol=1e-6, atol=1e-7)
    # the reference takes the same step the same way
    _, jstate = tr.jax_steps(variables, good + [bad], ema=0.9)
    assert int(jstate.bad_steps) == 1
    got = {n: e.detach().numpy() for n, e in state.ema_named().items()}
    assert tr.rel_l2(got, tr.to_port({"params": jstate.ema_params})) <= 1e-6


def test_eval_scores_the_ema_copy():
    """Zeroed EMA weights give uniform logits, so the eval loss is ln 10
    whatever the trained weights; the training weights stay as they
    were."""
    variables = tr.lenet_variables()
    data = tr.batches(2, 16)
    with tempfile.TemporaryDirectory() as work:
        trainer, state = tr.port_trainer(work, variables, ema=0.9)
        for e in state.ema:
            e.zero_()
        before = tr.numpy_sd(state.model)
        m = trainer.evaluate(state, data)
        assert m["loss"] == pytest.approx(np.log(10.0), abs=1e-4)
        for k, v in tr.numpy_sd(state.model).items():
            assert np.array_equal(v, before[k])
        trainer.ema_decay = 0.0
        state.ema = []
        assert abs(trainer.evaluate(state, data)["loss"] - np.log(10)) > 1e-2


@pytest.mark.parametrize("decay", [1.0, 1.5, -0.1])
def test_ema_decay_out_of_range_raises(decay):
    with pytest.raises(ValueError, match="ema_decay"):
        with tempfile.TemporaryDirectory() as work:
            tr.port_trainer(work, tr.lenet_variables(), ema=decay)


def test_ema_off_keeps_no_copy():
    with tempfile.TemporaryDirectory() as work:
        _, state = tr.port_trainer(work, tr.lenet_variables())
        assert state.ema == [] and state.save_dict()["ema"] == {}


def test_resume_enabling_ema_seeds_from_restored_params(tmp_path):
    variables = tr.lenet_variables()
    data = tr.batches(2, 16)
    work = str(tmp_path)
    trainer, state = tr.port_trainer(work, variables)
    state = trainer.fit(data, state=state)
    assert trainer.checkpointer.latest_step() == 2
    trainer1, fresh = tr.port_trainer(work, variables, ema=0.5)
    fresh = trainer1.maybe_resume(fresh)
    assert fresh.step == 2 and int(fresh.device_step) == 2
    for e, p in zip(fresh.ema, fresh.opt.params):
        assert torch.equal(e, p.detach())
    assert not torch.equal(fresh.ema[0], torch.from_numpy(
        tr.numpy_sd(tr.port_model(variables))[fresh.opt.names[0]]))
    fresh, m = trainer1.train_step(fresh, data[0])
    assert np.isfinite(float(m["loss"]))
    # and a checkpoint with an EMA resumes it as it was saved
    trainer1.save(fresh, 2)
    trainer2, again = tr.port_trainer(work, variables, ema=0.5)
    again = trainer2.maybe_resume(again)
    for e, saved in zip(again.ema, fresh.ema):
        assert torch.equal(e, saved)


def test_load_state_serves_the_ema_as_the_reference(tmp_path, mesh1):
    """The reference's test_infer_load_state_serves_ema_weights at the
    same weights: both trainers fit one epoch from them with the EMA on;
    each workdir serves its EMA copy, and the two served models agree."""
    variables = tr.lenet_variables()
    data = tr.batches(2, 16, seed=7)
    arrays = {k: np.concatenate([b[k] for b in data]) for k in data[0]}
    pwork, jwork = str(tmp_path / "port"), str(tmp_path / "jax")
    trainer, state = tr.port_trainer(pwork, variables, ema=0.9)
    final = trainer.fit(ArrayLoader(arrays, 16, shuffle=False), state=state)
    info = {}
    model = load_state(trainer.config, workdir=pwork, info=info,
                       log=lambda _m: None)
    assert info["ema"] == EMA_WEIGHTS
    served = tr.numpy_sd(model)
    for name, e in final.ema_named().items():
        assert np.array_equal(served[name], e.detach().numpy()), name
    raw = tr.port_model(variables)
    raw.load_state_dict(final.model.state_dict())
    assert info["digest"] != params_digest(raw)
    assert tr.rel_l2(served, tr.numpy_sd(final.model)) > 1e-3

    jtrainer, jstate = tr.jax_trainer(jwork, variables, ema=0.9)
    jfinal = jtrainer.fit(JaxArrayLoader(arrays, 16, shuffle=False),
                          state=jstate)
    jtrainer.checkpointer.wait_until_finished()
    _, jserved = jax_load_state(jtrainer.config, jwork)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        jax.device_get(jserved.params), jax.device_get(jfinal.ema_params))
    assert tr.rel_l2(served, tr.to_port({"params": jserved.params})) <= 1e-6


def test_workdir_without_ema_serves_the_trained_weights(tmp_path):
    variables = tr.lenet_variables()
    trainer, state = tr.port_trainer(str(tmp_path), variables)
    final = trainer.fit(tr.batches(1, 16), state=state)
    info = {}
    model = load_state(trainer.config, workdir=str(tmp_path), info=info,
                       log=lambda _m: None)
    assert info["ema"] == RAW_WEIGHTS
    assert params_digest(model) == params_digest(final.model)
    assert os.path.isdir(os.path.join(str(tmp_path), "checkpoints"))


def test_serving_paths_serve_the_ema(tmp_path):
    """``cli.serve --workdir`` (the registry's ``load_checkpoint``) and
    the plane's reload, which the deploy watcher's gate runs before a
    rollout, restore through ``load_state``: each serves the EMA copy
    that eval scored, and says so."""
    from types import SimpleNamespace

    from deep_vision_tpu_torch.serve.models import ModelControlPlane
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    work = str(tmp_path)
    trainer, state = tr.port_trainer(work, tr.lenet_variables(), ema=0.9)
    final = trainer.fit(tr.batches(2, 16), state=state)
    want = {**tr.numpy_sd(final.model),
            **{n: e.detach().numpy() for n, e in final.ema_named().items()}}
    sm = ModelRegistry().load_checkpoint("lenet5", workdir=work,
                                         device="cpu")
    reloaded = ModelControlPlane._load_model(
        None, SimpleNamespace(model=sm, workdir=work))
    for served in (sm, reloaded):
        assert served.restored_ema == EMA_WEIGHTS
        assert served.describe()["restored_ema"] == EMA_WEIGHTS
        got = tr.numpy_sd(served._model)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k

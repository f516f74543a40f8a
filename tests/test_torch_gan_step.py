"""One adversarial step of the port (``tasks/gan.py`` through
``core/adversarial.py``) on the CPU against the jitted JAX step
(``deep_vision_tpu/tasks/gan.py``) from the same flax weights:
DCGAN fed the reference's own ``z`` and dropout masks, CycleGAN on its
first step (no pool) and on a pooled one; BatchNorm running statistics
updated exactly once a network a step; the ``ImagePool`` replay
sequence; the joint divergence guard.

Tolerances: losses within 1e-5 relative; BatchNorm statistics within
1e-5 relative; each network's gradient (read as the update of SGD at
learning rate 1) within max(1e-4, 4× its floor) of its L2 norm.  The
floor is the largest change of the port's own gradient when the
weights move by 1e-6 (relative, three seeds), the size of the two
frameworks' float32 drift a few layers in.  A (leaky) ReLU input within
that drift of 0 takes the other side in one of them, and one such flip
moves a network's gradient by a finite amount: on these inputs a
single discriminator conv2 output within rounding of 0 has opposite
signs in the two and moves DCGAN's discriminator gradient by 2.8e-3,
and the port's own floor finds the same 2.8e-3 when its weights move;
CycleGAN's ``gen_b2a`` moves by 1.4% either way.  Where nothing
flips, the gradients agree to 1e-5.  Adam's first update (the recipes'
optimizer: about lr·sign(g), so an element whose gradient is within the
drift of 0 may take the other sign) must agree on all but 1% of the
elements it moves by at least lr/2.  Each check has a control that must
fail it (rolled z; swapped domains)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from _torch_port import seeded_variables
from _torch_zoo import FlaxMasks
from deep_vision_tpu.core.optim import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deep_vision_tpu.core.state import TrainState as JaxTrainState
from deep_vision_tpu.models import gan as jgan
from deep_vision_tpu.tasks import gan as jtasks
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.optim import OptimizerConfig
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.models.common import BatchNorm2d
from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask, ImagePool

LOSS_BOUND, GRAD_BOUND, STATS_BOUND = 1e-5, 1e-4, 1e-5
#: the floor: weights moved by this much (relative), seeds
FLOOR_MOVE, FLOOR_SEEDS, FLOOR_FACTOR = 1e-6, (0, 1, 2), 4.0
#: SGD at learning rate 1: its update is minus the gradient
SGD = dict(name="sgd", learning_rate=1.0, momentum=0.0)
DCGAN_BATCH, CYCLE_SIZE, CYCLE_BLOCKS = 8, 32, 2


def _dcgan_variables():
    g = jgan.DCGANGenerator()
    shapes = jax.eval_shape(lambda: g.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 100))))
    rng = np.random.RandomState(0)

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

    vg = jax.tree_util.tree_map_with_path(leaf, shapes)
    vd = seeded_variables(jgan.DCGANDiscriminator(), (28, 28, 1), seed=1)
    return {"generator": vg, "discriminator": vd}


def _cycle_variables():
    out = {}
    for i, name in enumerate(("gen_a2b", "gen_b2a", "disc_a", "disc_b")):
        model = jgan.CycleGANGenerator(n_blocks=CYCLE_BLOCKS) \
            if name.startswith("gen") else jgan.PatchGANDiscriminator()
        out[name] = seeded_variables(model, (CYCLE_SIZE, CYCLE_SIZE, 3),
                                     seed=10 + i)
    return out


@functools.cache
def _jax_tx(opt_items: tuple):
    """One optax transformation per optimizer config: a TrainState's
    ``tx`` is a static field, so a new one would recompile the step."""
    return jax_build_optimizer(JaxOptimizerConfig(**dict(opt_items)))


def _jax_states(models: dict, variables: dict, opt) -> dict:
    tx = _jax_tx(tuple(sorted(opt.items())))
    return {n: JaxTrainState.create(
                apply_fn=models[n].apply,
                params=jax.tree_util.tree_map(jnp.asarray,
                                              variables[n]["params"]),
                tx=tx, batch_stats=jax.tree_util.tree_map(
                    jnp.asarray, variables[n].get("batch_stats", {})),
                rng=jax.random.PRNGKey(0))
            for n in models}


def _port(task, variables: dict, name: str, tmp_path):
    trainer = AdversarialTrainer(get_config(name), task,
                                 workdir=str(tmp_path), device="cpu")
    models = task.init_models(torch.Generator().manual_seed(0))
    for n, m in models.items():
        convert.load_gan(m, variables[n])
    return trainer, trainer.states_for(models)


def _after(states) -> dict:
    """Every network's state_dict (numpy) after the port's step."""
    return {n: {k: v.detach().numpy().copy()
                for k, v in st.model.state_dict().items()}
            for n, st in states.items()}


def _reference_after(new_states, states_models) -> dict:
    """The JAX states after the step, in the port's layout."""
    out = {}
    for n, st in new_states.items():
        v = {"params": jax.device_get(st.params)}
        if st.batch_stats:
            v["batch_stats"] = jax.device_get(st.batch_stats)
        out[n] = convert.gan_from_flax(v, states_models[n])
    return out


def _grad_errors(got: dict, want: dict, init_got: dict,
                 init_want: dict) -> dict:
    """Per network: ‖g_got − g_want‖ / ‖g_want‖ over its parameters, the
    gradients read as the SGD(lr 1) updates from each side's init."""
    out = {}
    for n in want:
        num = den = 0.0
        for k, w in want[n].items():
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
                continue
            dg, dw = init_got[n][k] - got[n][k], init_want[n][k] - w
            num += float(np.sum((dg - dw) ** 2))
            den += float(np.sum(dw ** 2))
        out[n] = (num / max(den, 1e-30)) ** 0.5
    return out


def _stats(got: dict, want: dict):
    for n in want:
        for k, w in want[n].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[n][k], w, rtol=STATS_BOUND,
                                           atol=STATS_BOUND,
                                           err_msg=f"{n}/{k}")


def _moved(variables: dict, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {n: jax.tree_util.tree_map(
                lambda a: (a * (1 + FLOOR_MOVE * rs.randn(*a.shape)))
                .astype(np.float32), v)
            for n, v in variables.items()}


def _floor(run, variables: dict, got: dict, init: dict) -> dict:
    """Per network, the largest change of the port's gradient over
    FLOOR_SEEDS moves of the weights (``run(variables)`` → (init,
    after))."""
    floor: dict = {}
    for seed in FLOOR_SEEDS:
        i2, a2 = run(_moved(variables, seed))
        for n, e in _grad_errors(a2, got, i2, init).items():
            floor[n] = max(floor.get(n, 0.0), e)
    return floor


def _hold_gradients(got, want, init, floor) -> dict:
    errs = _grad_errors(got, want, init, init)
    for n, e in errs.items():
        assert e <= max(GRAD_BOUND, FLOOR_FACTOR * floor[n]), \
            (n, e, floor[n])
    return errs


def _losses(got: dict, want: dict):
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= LOSS_BOUND * abs(w), (k, got[k], w)


def _dcgan_reference(opt, roll_z: bool = False):
    """The jitted JAX step: (variables, batch, the port's draws holding
    the reference's own z and masks, reference states after, metrics)."""
    variables = _dcgan_variables()
    jmodels = {"generator": jgan.DCGANGenerator(),
               "discriminator": jgan.DCGANDiscriminator()}
    jtask = jtasks.DCGANTask(jmodels["generator"], jmodels["discriminator"],
                             opt=JaxOptimizerConfig(**opt))
    rng = jax.random.PRNGKey(3)
    batch = {"image": np.tanh(np.random.RandomState(4).randn(
        DCGAN_BATCH, 28, 28, 1)).astype(np.float32)}
    masks = FlaxMasks(seed=5)
    with fnn.intercept_methods(masks):
        new_states, _, jmetrics = jax.jit(jtask.train_step)(
            _jax_states(jmodels, variables, opt), batch, rng)
    assert len(masks.masks) == 6
    # the reference's own z: the first of the step rng's four splits
    z = np.array(jax.random.normal(jax.random.split(rng, 4)[0],
                                   (DCGAN_BATCH, 100)))
    draws = {"z": torch.from_numpy(np.roll(z, 1, 0) if roll_z else z),
             **{name: [torch.from_numpy(m) for m in
                       masks.masks[2 * i:2 * i + 2]]
                for i, name in enumerate(("drop_g", "drop_real",
                                          "drop_fake"))}}
    return variables, batch, draws, new_states, jmetrics


def _dcgan_run(opt, variables, batch, draws, tmp_path):
    task = DCGANTask(gan.DCGANGenerator, gan.DCGANDiscriminator,
                     opt=OptimizerConfig(**opt))
    trainer, states = _port(task, variables, "dcgan", tmp_path)
    init = _after(states)
    _, metrics = trainer.train_step(states, batch, draws=draws)
    return init, _after(states), metrics, states


def test_dcgan_step_matches_reference(tmp_path):
    variables, batch, draws, new_states, jm = _dcgan_reference(SGD)
    init, got, m, states = _dcgan_run(SGD, variables, batch, draws,
                                      tmp_path)
    assert int(m["bad_steps"]) == 0
    _losses(m, jm)
    want = _reference_after(new_states, {n: st.model
                                         for n, st in states.items()})
    _stats(got, want)
    floor = _floor(lambda v: _dcgan_run(SGD, v, batch, draws,
                                        tmp_path)[:2], variables, got, init)
    errs = _hold_gradients(got, want, init, floor)
    assert errs["generator"] <= GRAD_BOUND


def _flipped_share(got: dict, want: dict, init: dict, lr: float) -> float:
    off = held = 0
    for n in want:
        for k, w in want[n].items():
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
                continue
            moved = np.abs(w - init[n][k]) >= lr / 2
            held += int(moved.sum())
            off += int(np.sum((np.abs(got[n][k] - w) > lr / 100) & moved))
    assert held > 0
    return off / held


def test_dcgan_adam_step_matches_reference(tmp_path):
    """The recipe's Adam(1e-4): the first update is lr·g/(|g| + eps)."""
    opt = dict(name="adam", learning_rate=1e-4)
    variables, batch, draws, new_states, jm = _dcgan_reference(opt)
    init, got, m, states = _dcgan_run(opt, variables, batch, draws,
                                      tmp_path)
    _losses(m, jm)
    want = _reference_after(new_states, {n: st.model
                                         for n, st in states.items()})
    _stats(got, want)
    assert _flipped_share(got, want, init, 1e-4) <= 1e-2


def test_dcgan_step_with_rolled_z_fails(tmp_path):
    """The control: the same step with z rolled by one image misses the
    loss and gradient bounds."""
    variables, batch, draws, new_states, jm = _dcgan_reference(
        SGD, roll_z=True)
    init, got, m, states = _dcgan_run(SGD, variables, batch, draws,
                                      tmp_path)
    with pytest.raises(AssertionError):
        _losses(m, jm)
    want = _reference_after(new_states, {n: st.model
                                         for n, st in states.items()})
    errs = _grad_errors(got, want, init, init)
    assert min(errs.values()) > 100 * GRAD_BOUND


def _cycle_batch(pooled: bool, seed: int = 20) -> dict:
    rng = np.random.RandomState(seed)
    img = lambda: np.tanh(rng.randn(1, CYCLE_SIZE, CYCLE_SIZE, 3)  # noqa: E731
                          ).astype(np.float32)
    batch = {"image_a": img(), "image_b": img()}
    if pooled:
        batch.update(pool_a2b=img(), pool_b2a=img(),
                     pool_valid=np.ones((), np.float32))
    else:
        batch.update(pool_a2b=np.zeros_like(batch["image_b"]),
                     pool_b2a=np.zeros_like(batch["image_a"]),
                     pool_valid=np.zeros((), np.float32))
    return batch


def _cycle_tasks(opt):
    jtask = jtasks.CycleGANTask(
        lambda: jgan.CycleGANGenerator(n_blocks=CYCLE_BLOCKS),
        jgan.PatchGANDiscriminator, opt=JaxOptimizerConfig(**opt))
    task = CycleGANTask(lambda: gan.CycleGANGenerator(CYCLE_BLOCKS),
                        gan.PatchGANDiscriminator,
                        opt=OptimizerConfig(**opt))
    jmodels = {"gen_a2b": jgan.CycleGANGenerator(n_blocks=CYCLE_BLOCKS),
               "gen_b2a": jgan.CycleGANGenerator(n_blocks=CYCLE_BLOCKS),
               "disc_a": jgan.PatchGANDiscriminator(),
               "disc_b": jgan.PatchGANDiscriminator()}
    return jtask, task, jmodels


def _cycle_run(variables, batch, tmp_path):
    _, task, _ = _cycle_tasks(SGD)
    trainer, states = _port(task, variables, "cyclegan", tmp_path)
    init = _after(states)
    out, metrics = trainer.train_step(states, batch)
    return init, _after(states), metrics, states, out


@functools.cache
def _cycle_jitted_step():
    jtask, _, jmodels = _cycle_tasks(SGD)
    return jax.jit(jtask.train_step), jmodels


@functools.cache
def _cycle_reference(pooled: bool):
    """The jitted JAX step on the first (no pool) or a pooled batch:
    (variables, batch, reference states after, host outputs, metrics);
    one compile for both."""
    step, jmodels = _cycle_jitted_step()
    variables = _cycle_variables()
    batch = _cycle_batch(pooled)
    new_states, outputs, jmetrics = step(
        _jax_states(jmodels, variables, SGD), batch, jax.random.PRNGKey(0))
    return variables, batch, new_states, outputs, jmetrics


@pytest.mark.parametrize("pooled", [False, True], ids=["first", "pooled"])
def test_cyclegan_step_matches_reference(pooled, tmp_path):
    variables, batch, new_states, outputs, jmetrics = \
        _cycle_reference(pooled)
    init, got, m, states, out = _cycle_run(variables, batch, tmp_path)
    assert int(m["bad_steps"]) == 0
    assert set(jmetrics) <= set(m)
    _losses(m, jmetrics)
    for k in ("fake_a2b", "fake_b2a"):
        ref = np.asarray(outputs[k])
        np.testing.assert_allclose(out[k].numpy(), ref, rtol=0,
                                   atol=GRAD_BOUND * np.abs(ref).max())
    want = _reference_after(new_states, {n: st.model
                                         for n, st in states.items()})
    _stats(got, want)
    floor = _floor(lambda v: _cycle_run(v, batch, tmp_path)[:2],
                   variables, got, init)
    _hold_gradients(got, want, init, floor)


def test_cyclegan_swapped_domains_fail(tmp_path):
    """The control: the port's step with A and B swapped misses the
    loss and gradient bounds."""
    variables, batch, new_states, _, jmetrics = _cycle_reference(True)
    swapped = dict(batch, image_a=batch["image_b"], image_b=batch["image_a"])
    init, got, m, states, _ = _cycle_run(variables, swapped, tmp_path)
    with pytest.raises(AssertionError):
        _losses(m, jmetrics)
    want = _reference_after(new_states, {n: st.model
                                         for n, st in states.items()})
    errs = _grad_errors(got, want, init, init)
    assert min(errs.values()) > 100 * GRAD_BOUND


def _count_bn_updates(states) -> tuple[dict, list]:
    """Forward pre-hooks counting, per network, the training forwards
    of each BatchNorm that update its running statistics."""
    counts: dict = {}
    handles = []
    for n, st in states.items():
        for name, m in st.model.named_modules():
            if isinstance(m, BatchNorm2d):
                def hook(mod, _inputs, key=(n, name)):
                    if mod.training and mod.update_stats:
                        counts[key] = counts.get(key, 0) + 1
                handles.append(m.register_forward_pre_hook(hook))
                counts[(n, name)] = 0
    return counts, handles


@pytest.mark.parametrize("name", ["dcgan", "cyclegan"])
def test_each_network_takes_one_bn_update_a_step(name, tmp_path):
    """The reference's every forward starts from the step's old
    statistics and keeps one update a network; a second update of any
    BatchNorm in a step fails this."""
    if name == "dcgan":
        task = DCGANTask(gan.DCGANGenerator, gan.DCGANDiscriminator)
        batch = {"image": np.zeros((4, 28, 28, 1), np.float32)}
    else:
        _, task, _ = _cycle_tasks(SGD)
        batch = _cycle_batch(True)
    trainer = AdversarialTrainer(get_config(name), task,
                                 workdir=str(tmp_path), device="cpu")
    if name == "cyclegan":
        states = trainer.states_for(task.init_models(
            torch.Generator().manual_seed(0)))
    else:
        states = trainer.init_states()
    counts, handles = _count_bn_updates(states)
    try:
        for step in range(2):
            trainer.train_step(states, batch)
            assert counts and set(counts.values()) == {step + 1}, counts
    finally:
        for h in handles:
            h.remove()
    nets = {n for n, _ in counts}
    assert nets == ({"generator"} if name == "dcgan"
                    else {"gen_a2b", "gen_b2a", "disc_a", "disc_b"})


@pytest.mark.parametrize("batch", [1, 3])
def test_image_pool_replays_the_reference_sequence(batch):
    rng = np.random.RandomState(batch)
    ref, port = jtasks.ImagePool(50, seed=1), ImagePool(50, seed=1)
    replayed = 0
    for q in range(120):
        imgs = rng.randn(batch, 4, 4, 3).astype(np.float32)
        want, got = ref.query(imgs), port.query(imgs)
        np.testing.assert_array_equal(got, want, err_msg=f"query {q}")
        replayed += int(not np.array_equal(got, imgs))
    assert replayed > 10


def _snapshot(states) -> dict:
    out = {}
    for n, st in states.items():
        sd = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        opt = st.opt.state_dict()
        sd.update({f"mu/{k}": v.clone() for k, v in opt["mu"].items()})
        sd.update({f"nu/{k}": v.clone() for k, v in opt["nu"].items()})
        sd["count"] = opt["count"].clone()
        out[n] = sd
    return out


@pytest.mark.parametrize("fault", ["nan_image", "one_network_diverges"])
def test_joint_guard_reverts_every_network(fault, tmp_path):
    """A non-finite loss, or one network's non-finite proposed
    parameters, reverts all four networks' parameters, Adam state and
    BatchNorm statistics and counts a bad step on each."""
    _, task, _ = _cycle_tasks(dict(name="adam", learning_rate=2e-4, b1=0.5))
    trainer = AdversarialTrainer(get_config("cyclegan"), task,
                                 workdir=str(tmp_path), device="cpu")
    states = trainer.states_for(task.init_models(
        torch.Generator().manual_seed(0)))
    batch = _cycle_batch(True)
    trainer.train_step(states, batch)  # a good step first: moments set
    before = _snapshot(states)
    if fault == "nan_image":
        batch = dict(batch, image_a=np.full_like(batch["image_a"], np.nan))
    else:
        states["disc_b"].opt.set_learning_rate(float("inf"))
    _, m = trainer.train_step(states, batch)
    assert int(m["bad_steps"]) == 1
    after = _snapshot(states)
    for n, st in states.items():
        assert int(st.bad_steps) == 1 and st.step == 2
        for k, v in before[n].items():
            assert torch.equal(after[n][k], v), f"{n}/{k} moved"


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_translate_matches_reference(direction, tmp_path):
    """CycleGAN's inference path: the direction's generator in eval
    mode, as the reference's ``translate``."""
    variables = _cycle_variables()
    jtask, task, jmodels = _cycle_tasks(SGD)
    images = _cycle_batch(False)["image_a"]
    want = jtask.translate(_jax_states(jmodels, variables, SGD), images,
                           direction)
    _, states = _port(task, variables, "cyclegan", tmp_path)
    got = task.translate(states, images, direction)
    assert got.shape == want.shape == images.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_BOUND * np.abs(want).max())


def test_sample_draws_latents_into_the_generator(tmp_path):
    """DCGAN's inference path: ``n`` standard-normal latents from the
    caller's generator through the generator in eval mode."""
    variables = _dcgan_variables()
    task = DCGANTask(gan.DCGANGenerator, gan.DCGANDiscriminator)
    _, states = _port(task, variables, "dcgan", tmp_path)
    got = task.sample(states, 5, torch.Generator().manual_seed(9))
    z = torch.randn((5, 100), generator=torch.Generator().manual_seed(9))
    want = jgan.DCGANGenerator().apply(variables["generator"],
                                       jnp.asarray(z.numpy()), train=False)
    assert got.shape == (5, 28, 28, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=GRAD_BOUND * np.abs(want).max())

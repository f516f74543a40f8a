"""One data-parallel DCGAN step of the port's adversarial trainer
(``core/adversarial.py`` under a mesh) against the jitted JAX step on a
``{"data": 2}`` mesh of two virtual CPU devices (the global batch
sharded over ``data``, the states replicated: GSPMD normalizes every
BatchNorm over the global batch).  The port runs as two gloo ranks on
the CPU (``tests/_torch_dist_worker.py``), each fed its device's rows of
the batch, of the reference's own ``z`` and of its dropout masks
(``_torch_zoo.FlaxMasks``), at tests/test_torch_gan_step.py's setup:
global batch 8, SGD at learning rate 1, so an update reads as minus the
gradient.

Bounds: losses within 1e-5 relative and BatchNorm running statistics
(one update a network) within 1e-5, as tests/test_torch_gan_step.py's;
each network's gradient against the reference within max(1e-4, twice
the port's own one-process error against the same reference (a
leaky-ReLU input within float32 drift of 0 takes the other side in one
framework and moves a gradient by a finite amount; that file holds the
one-process error against the port's own floor), and against the
port's one-process step on the whole batch within 1e-4 (two ranks sum
in another order).  Measured on the CPU: the discriminator 2.77e-3 and
the generator 2.1e-6 for both the ranks and the one process (the
discriminator's one flip), 1.4e-6 between them; statistics at 0.006 of
their bound.  Control: rank-local BatchNorm statistics miss the
statistics bound (they read 1,860 times it).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
from flax import linen as fnn

from _torch_dist_worker import run_ranks
from _torch_zoo import FlaxMasks
from deep_vision_tpu.core.optim import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.models import gan as jgan
from deep_vision_tpu.parallel import make_mesh, replicate, shard_batch
from deep_vision_tpu.tasks import gan as jtasks
from test_torch_gan_step import (
    DCGAN_BATCH,
    SGD,
    _dcgan_variables,
    _grad_errors,
    _jax_states,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import gan

LOSS_BOUND, STATS_BOUND, GRAD_BOUND = 1e-5, 1e-5, 1e-4


@functools.cache
def _reference():
    """The jitted JAX step on the data=2 mesh: (batch, draws in numpy,
    the states after it in the port's layout, metrics)."""
    variables = _dcgan_variables()
    jmodels = {"generator": jgan.DCGANGenerator(),
               "discriminator": jgan.DCGANDiscriminator()}
    jtask = jtasks.DCGANTask(jmodels["generator"], jmodels["discriminator"],
                             opt=JaxOptimizerConfig(**SGD))
    rng = jax.random.PRNGKey(3)
    batch = {"image": np.tanh(np.random.RandomState(4).randn(
        DCGAN_BATCH, 28, 28, 1)).astype(np.float32)}
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    masks = FlaxMasks(seed=5)
    with fnn.intercept_methods(masks):
        new_states, _, jm = jax.jit(jtask.train_step)(
            replicate(_jax_states(jmodels, variables, SGD), mesh),
            shard_batch(batch, mesh), rng)
    z = np.array(jax.random.normal(jax.random.split(rng, 4)[0],
                                   (DCGAN_BATCH, 100)))
    draws = {"z": z, **{name: list(masks.masks[2 * i:2 * i + 2])
                        for i, name in enumerate(("drop_g", "drop_real",
                                                  "drop_fake"))}}
    ports = {"generator": gan.DCGANGenerator(),
             "discriminator": gan.DCGANDiscriminator()}
    after = {}
    for n, st in new_states.items():
        v = {"params": jax.device_get(st.params)}
        if st.batch_stats:
            v["batch_stats"] = jax.device_get(st.batch_stats)
        after[n] = convert.gan_from_flax(v, ports[n])
    init = {n: convert.gan_from_flax(variables[n], ports[n])
            for n in ports}
    return batch, draws, after, init, {k: float(v) for k, v in jm.items()}


@functools.cache
def _runs():
    batch, draws, _, _, _ = _reference()
    call = dict(variables=_dcgan_variables(), batch=batch, draws=draws)
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(run_ranks, 2, [
            ("dcgan_step", call), ("dcgan_step", dict(call,
                                                      local_stats=True))])
        alone = pool.submit(run_ranks, 0, [("dcgan_step", call)])
        return two.result(), alone.result()[0][0]


def _stats_err(got: dict, want: dict) -> float:
    """The running statistics' worst error in units of the bound
    (``STATS_BOUND`` relative and absolute): at most 1 holds it."""
    worst = 0.0
    for n in want:
        for k, w in want[n].items():
            if k.endswith(("running_mean", "running_var")):
                err = np.abs(got[n][k] - w) / (STATS_BOUND * (1 + np.abs(w)))
                worst = max(worst, float(np.max(err)))
    return worst


def test_two_ranks_match_the_jax_mesh_step():
    _, _, want, init, jm = _reference()
    two, alone = _runs()
    floor = _grad_errors(alone["after"], want, init, init)
    for rank in (0, 1):
        got = two[rank][0]
        for k, w in jm.items():
            assert abs(got["metrics"][k] - w) <= LOSS_BOUND * abs(w), \
                (k, got["metrics"][k], w)
        assert got["metrics"]["bad_steps"] == 0
        assert _stats_err(got["after"], want) <= 1.0
        errs = _grad_errors(got["after"], want, init, init)
        for n, e in errs.items():
            assert e <= max(GRAD_BOUND, 2 * floor[n]), (n, e, floor[n])
        own = _grad_errors(got["after"], alone["after"], init, init)
        assert max(own.values()) <= GRAD_BOUND, own
    a, b = two[0][0]["after"], two[1][0]["after"]
    assert all(np.array_equal(a[n][k], b[n][k]) for n in a for k in a[n])


def test_rank_local_batchnorm_statistics_fail():
    _, _, want, _, _ = _reference()
    two, _ = _runs()
    assert _stats_err(two[0][1]["after"], want) > 1.0

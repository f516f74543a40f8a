"""Shared helpers of the pipeline tests (tests/test_torch_pipeline*.py):
the reference's toy stacked models, their pipelined flax trees from
seeded weights, the port's ``PipelinedModel`` loaded from the same tree
(``convert.load_pipelined``), seeded batches, and the reference's step
taken as one ``jax.value_and_grad`` through its ``PipelinedModel.apply``
with a plain SGD update (``p − lr·g``), which the port's SGD at momentum
0 takes too.

The sizes are the reference's pipeline tests': a Stacked Hourglass of
order 1 at 8 filters and 3 heatmaps, 32², and an order-2 CenterNet at
filters (8, 8, 12) with 3 classes, 32².  SGD, not Adam, for step parity:
the biases of convs that feed a BatchNorm have a gradient that is
rounding noise, which Adam turns into a full ±lr step
(tests/test_pipeline_trainer.py's note); SGD keeps it at noise."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from deep_vision_tpu.models.centernet import CenterNet as JaxCenterNet
from deep_vision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deep_vision_tpu.parallel import make_mesh as jax_make_mesh
from deep_vision_tpu.parallel.pipelined import (
    PipelinedModel as JaxPipelinedModel,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import TrainConfig
from deep_vision_tpu_torch.core.optim import OptimizerConfig
from deep_vision_tpu_torch.models.centernet import CenterNet
from deep_vision_tpu_torch.models.hourglass import StackedHourglass
from deep_vision_tpu_torch.parallel import make_mesh
from deep_vision_tpu_torch.parallel.pipelined import PipelinedModel

SIZE, HEAT, CLASSES = 32, 3, 3
#: the update bound of a step (‖got−want‖ / ‖want−init‖ over the
#: parameters, and apart over the BatchNorm statistics: step_errors)
#: and the loss's relative bound
STEP_BOUND, LOSS_RTOL = 1e-3, 1e-5


def hourglass(num_stack: int):
    """(reference, port) monolithic toy Stacked Hourglass."""
    arch = dict(num_stack=num_stack, num_heatmap=HEAT, filters=8, order=1)
    return JaxHourglass(dtype=jnp.float32, **arch), StackedHourglass(**arch)


def centernet(num_stack: int):
    """(reference, port) monolithic toy CenterNet."""
    arch = dict(num_classes=CLASSES, num_stack=num_stack, order=2,
                filters=(8, 8, 12))
    return JaxCenterNet(dtype=jnp.float32, **arch), CenterNet(**arch)


FAMILIES = {"hourglass": hourglass, "centernet": centernet}


def jax_mesh(data: int, pipe: int):
    return jax_make_mesh({"data": data, "pipe": pipe},
                         devices=jax.devices()[:data * pipe])


def port_mesh(data: int, pipe: int):
    """The port's mesh of this process's ranks (none: one) with ``pipe``
    places on the CPU."""
    return make_mesh({"data": data, "pipe": pipe}, devices=list(range(data)),
                     pipe_device="cpu")


def _scale_heads(family: str, mv: dict) -> dict:
    """The heads start near their targets' scale: the hourglass's
    heatmap convs by 1e-2; CenterNet's heads' output convs by 1/10 with
    the heatmap's bias at the −2.19 prior (tests/test_torch_centernet_
    step.py), so the focal loss is not saturated."""
    p = mv["params"]
    for key, sub in p.items():
        if family == "hourglass" and key.startswith("Conv_") and \
                int(key[5:]) >= 2 and (int(key[5:]) - 2) % 4 == 0:
            sub["kernel"] = sub["kernel"] * 1e-2
        if family == "centernet" and key.startswith("DetectionHead_"):
            sub["Conv_1"]["kernel"] = sub["Conv_1"]["kernel"] * 0.1
            if int(key.rsplit("_", 1)[1]) % 3 == 0:
                sub["Conv_1"]["bias"] = np.full_like(sub["Conv_1"]["bias"],
                                                     -2.19)
    return mv


@functools.cache
def variables(family: str, num_stack: int, seed: int = 3):
    """(pipelined flax tree, monolithic flax tree) of the same seeded
    weights (non-zero BatchNorm scales), split by the reference's own
    ``import_monolithic_variables``; the last stage's re-injection convs,
    which no output reads and no gradient reaches, come from a template
    of small seeded values."""
    jmono, _ = FAMILIES[family](num_stack)
    mv = _scale_heads(family, tp.seeded_variables(jmono, (SIZE, SIZE, 3),
                                                  seed=seed))
    jpm = JaxPipelinedModel.for_model(jmono, jax_mesh(1, 1))
    shapes = jax.eval_shape(lambda: jpm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.RandomState(seed + 1)
    pv = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.05).astype(np.float32), shapes)
    conv = jpm.import_monolithic_variables(mv, pv)
    return jax.tree_util.tree_map(np.asarray, conv), mv


def port_pipelined(family: str, num_stack: int, mesh, micro=None,
                   seed: int = 3) -> PipelinedModel:
    """The port's pipelined toy of ``family`` loaded from the seeded
    tree and placed on ``mesh``'s pipe places."""
    _, mono = FAMILIES[family](num_stack)
    pm = PipelinedModel.for_model(mono, mesh, micro)
    convert.load_pipelined(pm, variables(family, num_stack, seed)[0])
    return pm.place()


@functools.cache
def pose_batch(n: int, seed: int = 11) -> dict:
    """Float images in [0, 1] and heatmaps with a quarter foreground."""
    rng = np.random.RandomState(seed)
    g = SIZE // 4
    return {"image": rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
            "heatmaps": np.maximum(rng.randn(n, g, g, HEAT) - 0.7, 0)
            .astype(np.float32)}


@functools.cache
def centernet_batch(n: int, seed: int = 11) -> dict:
    """A CenterNetLoader batch of seeded synthetic scenes, images scaled
    to [0, 1] on the host."""
    from deep_vision_tpu_torch.data.detection import (
        CenterNetLoader,
        synthetic_detection_dataset,
    )

    loader = CenterNetLoader(
        synthetic_detection_dataset(n, SIZE, CLASSES, seed=seed), n,
        CLASSES, SIZE, train=False, device_normalize=False)
    batch = next(iter(loader))
    batch.pop("weight")
    return {k: np.asarray(v) for k, v in batch.items()}


def train_config(family: str, lr: float, batch: int, **kw) -> TrainConfig:
    """The toy recipe with plain SGD (momentum 0) at ``lr``."""
    return TrainConfig(name=f"pipe_{family}", model=None,
                       task="pose" if family == "hourglass" else "centernet",
                       batch_size=batch, image_size=SIZE,
                       num_classes=HEAT if family == "hourglass" else CLASSES,
                       optimizer=OptimizerConfig(name="sgd",
                                                 learning_rate=lr,
                                                 momentum=0.0), **kw)


def jax_step(family: str, num_stack: int, data: int, pipe: int, micro: int,
             batch: dict, lr: float, task):
    """The reference's step on a ``{data, pipe}`` mesh: (loss, the
    pipelined flax tree after ``p − lr·g`` and the new statistics)."""
    jmono, _ = FAMILIES[family](num_stack)
    jpm = JaxPipelinedModel.for_model(jmono, jax_mesh(data, pipe), micro)
    v = variables(family, num_stack)[0]

    def loss_fn(params, stats, b):
        out, upd = jpm.apply({"params": params, "batch_stats": stats},
                             b["image"], train=True,
                             mutable=["batch_stats"])
        loss, _ = task.loss(out, b)
        return loss, upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, stats), grads = step(v["params"], v["batch_stats"],
                                {k: jnp.asarray(a) for k, a in batch.items()})
    params = jax.tree_util.tree_map(lambda p, g: np.asarray(p - lr * g),
                                    v["params"], grads)
    return float(loss), {"params": params,
                         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                               stats)}


def assert_rel(got, want, rtol: float = 1e-5) -> None:
    """``max|got − want| ≤ rtol · max|want|``: a forward's tolerance,
    relative to the output's scale (an element near 0 carries the
    rounding of the whole chain before it)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


STATS = ("running_mean", "running_var")


def step_errors(got: dict, want: dict, init: dict) -> dict:
    """``‖got − want‖ / ‖want − init‖`` over three numpy ``state_dict``s,
    apart for the parameters (``"params"``) and the BatchNorm running
    statistics (``"stats"``): the statistics' updates are the larger and
    would hide a fault of the parameters' in one ratio."""
    def ratio(keys):
        num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
        den = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
        return (num / den) ** 0.5

    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    stats = [k for k in keys if k.endswith(STATS)]
    return {"params": ratio([k for k in keys if k not in stats]),
            **({"stats": ratio(stats)} if stats else {})}


def assert_step(got: dict, want: dict, init: dict) -> None:
    """Both of :func:`step_errors` within :data:`STEP_BOUND`."""
    errs = step_errors(got, want, init)
    assert max(errs.values()) <= STEP_BOUND, errs


def detached_hand_offs(pm) -> list:
    """A gradient fault for a control: the first stage of every pipe
    place after the first takes a detached copy of its input, as a
    hand-off that cut the backward would; the forward is unchanged.
    Returns the hooks' handles."""
    per = pm.num_stages // len(pm.places)
    return [pm.stages[s].register_forward_pre_hook(
        lambda mod, args: (args[0].detach(), *args[1:]))
        for s in range(per, pm.num_stages, per)]


def numpy_sd(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}

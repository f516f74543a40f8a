"""SGD's Nesterov update and its bfloat16 momentum (``nesterov``,
``momentum_dtype``) against optax, and the recipe flags of ``cli.train``
against the reference's, on the CPU.

The optimizers run on the same numpy gradients over six steps, one of
them large enough that the global-norm clip cuts it, with weight decay
on the decay mask.  optax runs eagerly: its ``trace`` then rounds as
written (``decay·trace`` a bfloat16 product, rounded before the float32
add; the Nesterov update from the float32 trace; the stored trace cast
to bfloat16), and so does the port, so the stored bfloat16 trace is
equal bit for bit.  The parameters are held within 1e-6 relative: the
global norm of the clip is summed in another order (a float32 rounding
of the scale; without the clip they are equal bit for bit as well).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deep_vision_tpu.cli import train as jax_cli
from deep_vision_tpu.core import optim as jax_optim
from deep_vision_tpu.core import trainer as jax_trainer_module
from deep_vision_tpu_torch.cli import train as cli
from deep_vision_tpu_torch.core import optim as port_optim
from deep_vision_tpu_torch.core import trainer as port_trainer_module

#: a conv kernel and bias and a BatchNorm scale and bias: decayed, not
#: decayed, not decayed, not decayed
SHAPES = {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)},
          "bn": {"scale": (4,), "bias": (4,)}}


class _Model(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 4, 3)
        self.bn = torch.nn.BatchNorm2d(4)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(
                params["conv"]["kernel"].transpose(3, 2, 0, 1)))
            self.conv.bias.copy_(torch.from_numpy(params["conv"]["bias"]))
            self.bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
            self.bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))


def _to_port(tree):
    """flax-layout {conv, bn} leaves → the port's parameter order."""
    return [np.asarray(tree["conv"]["kernel"]).transpose(3, 2, 0, 1),
            np.asarray(tree["conv"]["bias"]), np.asarray(tree["bn"]["scale"]),
            np.asarray(tree["bn"]["bias"])]


def _trace(opt_state):
    """optax's TraceState trace inside the injected chain."""
    def find(s):
        if type(s).__name__ == "TraceState":
            return s.trace
        if isinstance(s, (tuple, list)):
            for x in s:
                got = find(x)
                if got is not None:
                    return got
        if hasattr(s, "inner_state"):
            return find(s.inner_state)
        return None
    return find(opt_state)


def _run(nesterov, momentum_dtype, clip, steps=6, f32_decay=False):
    rng = np.random.default_rng(0)
    params = {m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in leaves.items()} for m, leaves in SHAPES.items()}
    kw = dict(name="sgd", learning_rate=0.1, momentum=0.9, nesterov=nesterov,
              weight_decay=1e-3, grad_clip_norm=clip,
              momentum_dtype=momentum_dtype)
    model = _Model(params)
    opt = port_optim.build_optimizer(port_optim.OptimizerConfig(**kw), model)
    if f32_decay:
        opt.decay = kw["momentum"]
    tx = jax_optim.build_optimizer(jax_optim.OptimizerConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    for step in range(steps):
        scale = 3.0 if step == 2 else 0.3   # step 2 is clipped
        grads = {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                     for k, s in leaves.items()}
                 for m, leaves in SHAPES.items()}
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(np.ascontiguousarray(g))
                  for g in _to_port(grads)], torch.tensor(True))
    return opt, _to_port(jparams), _to_port(_trace(state))


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_sgd_matches_optax(nesterov, momentum_dtype, clip):
    opt, params, trace = _run(nesterov, momentum_dtype, clip)
    dtype = torch.bfloat16 if momentum_dtype else torch.float32
    for got, want in zip(opt.params, params):
        got = got.detach().numpy()
        if clip is None:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    for got, want in zip(opt.momentum, trace):
        assert got.dtype == dtype
        want = np.asarray(want)
        if momentum_dtype:
            # bit for bit, whatever the clip's rounding did upstream
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                want.astype(jnp.bfloat16).view(np.int16))
        elif clip is None:
            np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_trace_control():
    """The control of the bit-for-bit check: a trace that multiplies by
    the float32 decay (the port's scalar rule, had it not rounded the
    decay to bfloat16 first) misses optax's."""
    opt, _, trace = _run(False, "bfloat16", None, f32_decay=True)
    assert any(not np.array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).astype(jnp.bfloat16).view(np.int16))
        for got, want in zip(opt.momentum, trace))


def test_momentum_dtype_errors_are_the_references():
    model = _Model({m: {k: np.zeros(s, np.float32) for k, s in leaves.items()}
                    for m, leaves in SHAPES.items()})
    for kw, words in (({"momentum_dtype": "float16"},
                       "momentum_dtype must be None or 'bfloat16'"),
                      ({"name": "adam", "momentum_dtype": "bfloat16"},
                       "momentum_dtype applies to the sgd momentum "
                       "accumulator only")):
        with pytest.raises(ValueError, match=words) as port_err:
            port_optim.build_optimizer(port_optim.OptimizerConfig(**kw),
                                       model)
        with pytest.raises(ValueError) as ref_err:
            jax_optim.build_optimizer(jax_optim.OptimizerConfig(**kw))
        assert str(port_err.value) == str(ref_err.value)


def test_bf16_trace_round_trips_through_state_dict():
    opt, _, _ = _run(True, "bfloat16", 1.0)
    sd = opt.state_dict()
    fresh = port_optim.build_optimizer(opt.cfg, _Model(
        {m: {k: np.zeros(s, np.float32) for k, s in leaves.items()}
         for m, leaves in SHAPES.items()}))
    fresh.load_state_dict(sd)
    for a, b in zip(fresh.momentum, opt.momentum):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# -- cli.train's recipe flags -------------------------------------------------

FLAGS = ["--scan-steps", "3", "--grad-accum", "2", "--ema-decay", "0.999",
         "--momentum-dtype", "bfloat16"]
FIELDS = ("scan_steps", "grad_accum_steps", "ema_decay")


class _Built(Exception):
    """Raised by a patched Trainer constructor to stop ``main`` there."""


def _config_of(main, module, monkeypatch, argv):
    def stop(self, config, *args, **kwargs):
        raise _Built(config)

    monkeypatch.setattr(module.Trainer, "__init__", stop)
    with pytest.raises(_Built) as got:
        main(argv)
    return got.value.args[0]


@pytest.mark.parametrize("flags", [FLAGS, []])
def test_cli_flags_set_the_references_config(flags, monkeypatch, tmp_path):
    ref_args = jax_cli.build_parser().parse_args(["-m", "lenet5", *flags])
    args = cli.build_parser().parse_args(["-m", "lenet5", *flags])
    for name in ("scan_steps", "grad_accum", "ema_decay", "momentum_dtype"):
        assert getattr(args, name) == getattr(ref_args, name)
    argv = ["-m", "lenet5", "--synthetic", "--synthetic-size", "64",
            "--workdir", str(tmp_path), *flags]
    got = _config_of(cli.main, port_trainer_module, monkeypatch,
                     argv + ["--device", "cpu"])
    want = _config_of(jax_cli.main, jax_trainer_module, monkeypatch, argv)
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.optimizer.momentum_dtype == want.optimizer.momentum_dtype
    if flags:
        assert (got.scan_steps, got.grad_accum_steps, got.ema_decay,
                got.optimizer.momentum_dtype) == (3, 2, 0.999, "bfloat16")

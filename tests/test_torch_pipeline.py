"""``parallel/pipeline.py`` on the CPU against the reference's
``pipeline_apply`` (``deep_vision_tpu/parallel/pipeline.py``) with the
toy stage of tests/test_pipeline.py (a 3×3 SAME conv, a bias and tanh,
the carry its own output): every stage's outputs equal the port's
sequential stage loop exactly and the reference's pipeline within 1e-5
of the outputs' largest magnitude, for the reference's ``(n_pipe, S, M)`` cases, with gradients
of a loss over every output; the ``data`` axis composes (two gloo ranks,
each a pipe grid of two CPU places, against the reference on
``{data: 2, pipe: 2}``); the reference's ``ValueError`` words; and
``stack_stages``/``unstack_stages``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist_worker import ConvStage, run_ranks
from _torch_pipe import assert_rel
from deep_vision_tpu.parallel import make_mesh as jax_make_mesh
from deep_vision_tpu.parallel import pipeline_apply as jax_pipeline_apply
from deep_vision_tpu.parallel import stack_stages as jax_stack_stages
from deep_vision_tpu_torch.parallel import (
    make_mesh,
    pipeline_apply,
    stack_stages,
    unstack_stages,
)

C = 4


def _weights(s: int, key: int = 0) -> list:
    ks = jax.random.split(jax.random.PRNGKey(key), s)
    return [{"w": np.asarray(jax.random.normal(k, (3, 3, C, C)) * 0.3),
             "b": np.asarray(jax.random.normal(k, (C,)) * 0.1)} for k in ks]


def _jax_stage(p, x, state):
    y = jax.lax.conv_general_dilated(
        x, p["w"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = jnp.tanh(y + p["b"])
    return y, y, state


def _port(weights, n_pipe, data=1):
    mesh = make_mesh({"data": data, "pipe": n_pipe},
                     devices=list(range(data)), pipe_device="cpu")
    return mesh, [ConvStage(p["w"], p["b"]) for p in weights]


def _sequential(stages, x):
    outs, c = [], x
    for st in stages:
        c, o = st(c)
        outs.append(o)
    return outs


def _jax_run(weights, x, n_pipe, micro, data=1):
    mesh = jax_make_mesh({"data": data, "pipe": n_pipe} if data > 1
                         else {"pipe": n_pipe},
                         devices=jax.devices()[:data * n_pipe])
    outs, _ = jax_pipeline_apply(_jax_stage, jax_stack_stages(weights),
                                 jnp.asarray(x), mesh=mesh,
                                 num_microbatches=micro)
    return np.asarray(outs)


@pytest.mark.parametrize("n_pipe,n_stages,n_micro", [
    (4, 4, 4), (4, 4, 8), (4, 8, 2), (2, 2, 4)])
def test_pipeline_matches_sequential_and_the_reference(n_pipe, n_stages,
                                                       n_micro):
    weights = _weights(n_stages)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 6, 6, C)))
    mesh, stages = _port(weights, n_pipe)
    got = pipeline_apply(stages, torch.from_numpy(x), mesh, n_micro)
    want = _sequential(stages, torch.from_numpy(x))
    assert len(got) == n_stages
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = _jax_run(weights, x, n_pipe, n_micro)
    assert_rel(np.stack([g.detach().numpy() for g in got]), ref)


def test_pipeline_gradients_match_sequential_and_the_reference():
    weights = _weights(4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 5, 5, C)))
    mesh, stages = _port(weights, 4)

    def grads(run):
        for st in stages:
            st.zero_grad()
        loss = torch.stack(run(stages, torch.from_numpy(x))).square().mean()
        loss.backward()
        return [t.grad.clone() for st in stages for t in (st.w, st.b)]

    got = grads(lambda s, v: pipeline_apply(s, v, mesh, 2))
    seq = grads(_sequential)
    for g, w in zip(got, seq):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)

    jmesh = jax_make_mesh({"pipe": 4}, devices=jax.devices()[:4])

    def loss_pipe(p):
        outs, _ = jax_pipeline_apply(_jax_stage, p, jnp.asarray(x),
                                     mesh=jmesh, num_microbatches=2)
        return jnp.mean(outs ** 2)

    ref = jax.jit(jax.grad(loss_pipe))(jax_stack_stages(weights))
    for s in range(4):
        assert_rel(got[2 * s].numpy(),
                   np.asarray(ref["w"][s]).transpose(3, 2, 0, 1))
        assert_rel(got[2 * s + 1].numpy(), np.asarray(ref["b"][s]))


def test_pipeline_composes_with_data_ranks():
    """Two gloo ranks, each with pipe=2 CPU places, run their contiguous
    rows of the global batch: together the reference's outputs on
    ``{data: 2, pipe: 2}``."""
    weights = _weights(4, key=5)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (8, 6, 6, C)))
    ranks = run_ranks(2, [("pipeline", {"weights": weights, "x": x,
                                        "pipe": 2, "micro": 2})])
    got = np.concatenate([r[0] for r in ranks], axis=1)
    ref = _jax_run(weights, x, 2, 2, data=2)
    assert got.shape == ref.shape == (4, 8, 6, 6, C)
    assert_rel(got, ref)


def _error(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("n_stages,batch,micro", [(3, 8, 2), (4, 6, 4)])
def test_indivisible_shapes_raise_the_reference_words(n_stages, batch,
                                                      micro):
    weights = _weights(n_stages)
    x = np.zeros((batch, 6, 6, C), np.float32)
    mesh, stages = _port(weights, 2)
    want = _error(_jax_run, weights, x, 2, micro)
    assert _error(pipeline_apply, stages, torch.from_numpy(x), mesh,
                  micro) == want


def test_extra_mesh_axes_raise_the_reference_words():
    weights = _weights(2)
    x = np.zeros((4, 6, 6, C), np.float32)
    jmesh = jax_make_mesh({"pipe": 2, "model": 1}, devices=jax.devices()[:2])
    want = _error(jax_pipeline_apply, _jax_stage, jax_stack_stages(weights),
                  jnp.asarray(x), mesh=jmesh, num_microbatches=2)
    mesh = make_mesh({"pipe": 2, "model": 1}, pipe_device="cpu")
    stages = [ConvStage(p["w"], p["b"]) for p in weights]
    assert _error(pipeline_apply, stages, torch.from_numpy(x), mesh,
                  2) == want


def test_stack_and_unstack_are_inverse():
    weights = _weights(3)
    stacked = stack_stages(weights)
    assert stacked["w"].shape == (3, 3, 3, C, C)
    np.testing.assert_array_equal(stacked["w"],
                                  np.asarray(jax_stack_stages(weights)["w"]))
    for a, b in zip(unstack_stages(stacked), weights):
        np.testing.assert_array_equal(a["w"], b["w"])
    t = stack_stages([{k: torch.from_numpy(v) for k, v in p.items()}
                      for p in weights])
    assert isinstance(t["b"], torch.Tensor) and t["b"].shape == (3, C)

"""The forward of the port's pipelined Stacked Hourglass on the CPU: four
stages over ``pipe=4`` (four CPU places) against the reference's
``PipelinedModel`` on ``{data: 1, pipe: 4}`` from the same seeded weights
(tests/_torch_pipe.py), in eval mode, within 1e-5 of the heatmaps'
largest magnitude; and at one microbatch, where every BatchNorm sees
the whole batch, the port's pipelined network equals its monolithic
network bit for bit in eval and training mode (heatmaps and the new
statistics), as the reference's equals its own, whose monolithic eval
forward is held here too.  One pipelined program of the reference is
compiled (its eval forward at the default four microbatches)."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import _torch_pipe as tpp
from deep_vision_tpu.parallel.pipelined import (
    PipelinedModel as JaxPipelinedModel,
)
from deep_vision_tpu_torch import convert

STACKS, PIPE, BATCH = 4, 4, 8


@functools.cache
def _reference():
    """(pipelined eval heatmaps, monolithic eval heatmaps)."""
    jmono, _ = tpp.hourglass(STACKS)
    conv, mv = tpp.variables("hourglass", STACKS)
    jpm = JaxPipelinedModel.for_model(jmono, tpp.jax_mesh(1, PIPE))
    x = jnp.asarray(tpp.pose_batch(BATCH)["image"])
    piped = jax.jit(lambda v, a: jpm.apply(v, a, train=False))(conv, x)
    mono = jax.jit(lambda v, a: jmono.apply(v, a, train=False))(mv, x)
    return [np.asarray(o) for o in piped], [np.asarray(o) for o in mono]


def _x():
    return torch.from_numpy(tpp.pose_batch(BATCH)["image"])


def _port(micro=None):
    return tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE),
                              micro)


def test_pipelined_eval_forward_matches_the_reference():
    piped, mono = _reference()
    pm = _port().eval()
    assert pm.num_microbatches == PIPE
    with torch.no_grad():
        got = pm(_x())
    assert len(got) == len(piped) == STACKS
    for g, w, m in zip(got, piped, mono):
        tpp.assert_rel(g.numpy(), w)
        tpp.assert_rel(w, m)  # the reference's own two networks


def _monolithic():
    _, mono = tpp.hourglass(STACKS)
    convert.load_stacked_hourglass(mono, tpp.variables("hourglass",
                                                       STACKS)[1])
    return mono


def test_one_microbatch_is_the_monolithic_network_bit_for_bit():
    pm, mono = _port(1), _monolithic()
    for train in (False, True):
        pm.train(train)
        mono.train(train)
        with torch.no_grad():
            got, want = pm(_x()), mono(_x())
        for g, w in zip(got, want):
            assert torch.equal(g, w), train
    merged = pm.export_monolithic_variables()
    for k, v in mono.state_dict().items():
        assert torch.equal(merged[k], v), k  # the statistics moved alike


def test_more_microbatches_normalize_each_alone():
    """At M=4 a stage's training BatchNorm sees its microbatch: the
    heatmaps are the monolithic stem's carry run through the stages one
    microbatch at a time, and the stages' statistics move four times."""
    pm, seq = _port(4).train(), _port(4).train()
    mono = _monolithic().train()
    x = _x()
    with torch.no_grad():
        got = pm(x)
        parts = []
        for c in seq.stem(x).split(BATCH // 4):
            outs = []
            for stage in seq.stages:
                c, o = stage(c)
                outs.append(o)
            parts.append(outs)
        whole = mono(x)
    for s in range(STACKS):
        assert torch.equal(got[s], torch.cat([p[s] for p in parts]))
        assert not torch.allclose(got[s], whole[s], rtol=1e-3, atol=1e-3)
    for (k, a), b in zip(pm.state_dict().items(), seq.state_dict().values()):
        assert torch.equal(a, b), k

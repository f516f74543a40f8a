"""The serving plane's observability and front-end pieces on the CPU,
against the JAX package: ``PromText`` renders byte-identical text,
``LatencyHistogram`` keeps the reference's state, ``MfuMeter`` does the
reference's arithmetic, the bucket FLOP count (``FlopCounterMode``) is
compared with XLA's cost analysis on the same LeNet-5 bucket (the ratio
is written down, not forced to 1), ``image_b64`` decodes to the
reference's exact input for one- and three-channel models on both wires
and answers 501 without PIL, ``TenantQoS`` parses, meters and sheds
alike, and the response cache keeps the reference's LRU accounting and
answers a repeat from cache until a reload changes the version."""

import base64
import dataclasses
import io
import sys
import threading
import types

import numpy as np
import pytest

from _torch_serve import (
    get,
    images,
    jax_lenet,
    lenet_model,
    lenet_variables,
    port_lenet,
    post,
    write_step,
)
from deep_vision_tpu.core import metrics as jmetrics
from deep_vision_tpu.obs import mfu as jmfu
from deep_vision_tpu.serve import admission as jadmission
from deep_vision_tpu.serve import cache as jcache
from deep_vision_tpu.serve import http as jhttp
from deep_vision_tpu_torch.core import metrics as pmetrics
from deep_vision_tpu_torch.obs import mfu as pmfu
from deep_vision_tpu_torch.serve import admission as padmission
from deep_vision_tpu_torch.serve import cache as pcache
from deep_vision_tpu_torch.serve import http as phttp

pytestmark = [pytest.mark.obs, pytest.mark.serve]

#: FlopCounterMode over XLA's cost analysis on LeNet-5 at buckets 1 and
#: 8, measured by this file on the CPU: XLA also counts the bias adds,
#: activations and pools, FlopCounterMode only the convolutions and
#: matrix products (2 × multiply-adds)
FLOP_RATIO_LENET5 = 0.9848414989679167


# -- Prometheus text ---------------------------------------------------------


def _render(mod, hist_state):
    p = mod.PromText()
    p.counter("dvt_x_total", 3, {"model": 'a"b\\c\nd'}, help="x")
    p.counter("dvt_x_total", 4, {"model": "e"})
    p.gauge("dvt_y", 0.1 + 0.2, {"bucket": "8", "model": "m"}, help="y")
    p.gauge("dvt_z", None, {})  # absent, never a fabricated 0
    p.gauge("dvt_b", True)
    p.gauge("dvt_big", 1e16)
    p.gauge("dvt_int_float", 7.0)
    p.histogram("dvt_lat_seconds", hist_state, {"model": "m"}, help="h")
    return p.render()


def test_promtext_byte_identical_to_reference():
    hist = pmetrics.LatencyHistogram()
    jhist = jmetrics.LatencyHistogram()
    for s in (5e-5, 1e-3, 0.02, 0.02, 3.0, 2e3):
        hist.record(s)
        jhist.record(s)
    assert hist.state_dict() == jhist.state_dict()
    text = _render(pmetrics, hist.state_dict())
    assert text == _render(jmetrics, jhist.state_dict())
    assert 'le="+Inf"' in text and "dvt_z" not in text
    for v in (3, 2.5, 1e-9, 1e15, 1e16, float("inf"), True, 10.0):
        assert pmetrics._prom_num(v) == jmetrics._prom_num(v)


# -- serving MFU -------------------------------------------------------------


def _meter_report(mod):
    m = mod.MfuMeter(peak=1e12)
    m.set_bucket_flops(8, 4e9, "flop_counter")
    m.set_bucket_flops(1, None)
    for bucket, images_, secs in ((8, 8, 0.004), (8, 5, 0.0035),
                                  (1, 1, 0.001), (8, 8, -1.0)):
        m.observe(bucket, images_, secs)
    return m, m.report()


def test_mfu_meter_arithmetic_matches_reference():
    pm, got = _meter_report(pmfu)
    jm, want = _meter_report(jmfu)
    # the port adds each bucket's own MFU beside the reference's keys
    assert got.pop("mfu_by_bucket") == {
        "8": pmfu.round_mfu(12e9 / 0.0075 / 1e12)}
    assert got == want
    assert got["serving_mfu"] == pmfu.round_mfu(12e9 / 0.0085 / 1e12)
    assert pmfu.MfuMeter.merged_report([pm, pm]) == \
        jmfu.MfuMeter.merged_report([jm, jm])
    for v in (None, 1.23456789e-8, 0.5):
        assert pmfu.round_mfu(v) == jmfu.round_mfu(v)


def test_mfu_peak_table_is_the_cards_only():
    assert pmfu.peak_flops_per_s("NVIDIA H100 80GB HBM3") == 989e12
    assert pmfu.peak_flops_per_s("TPU v5 lite") is None
    assert pmfu.peak_flops_per_s("Some Other GPU") is None
    m = pmfu.MfuMeter()  # no CUDA device here: no peak, no MFU
    m.set_bucket_flops(1, 1e9)
    m.observe(1, 1, 0.01)
    assert m.mfu() is None and m.report()["serving_mfu"] is None


def test_bucket_flops_vs_xla_cost_analysis():
    variables = lenet_variables()
    jsm, psm = jax_lenet(variables), port_lenet(variables)
    for b in (1, 8):
        jf, pf = jsm.compile_bucket(b), psm.compile_bucket(b)
        assert jf.flops_source == "xla_cost_analysis"
        assert pf.flops_source == "flop_counter"
        assert pf.cost_flops / jf.cost_flops == \
            pytest.approx(FLOP_RATIO_LENET5, rel=1e-9)
    # the fallback numerator is the reference's 2 · params · batch
    assert pmfu.params_flops_lower_bound(psm._model, 8) == \
        jmfu.params_flops_lower_bound(jsm._variables, 8)


# -- image_b64 ---------------------------------------------------------------


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("task,shape", [
    ("classification", (32, 32, 1)), ("classification", (48, 48, 3)),
    ("detection", (40, 40, 3)), ("gan_cyclegan", (40, 40, 3))])
@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_image_b64_decodes_like_reference(task, shape, wire):
    rng = np.random.RandomState(4)
    arr = rng.randint(0, 256, (57, 71, 3)).astype(np.uint8)
    if shape[-1] == 1:
        arr = arr[..., 0]
    body = {"image_b64": _png(arr)}
    model = types.SimpleNamespace(wire_dtype=np.dtype(wire),
                                  input_shape=shape, task=task)
    got = phttp.decode_pixels(body, model)
    want = jhttp._decode_pixels(body, model)
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    assert np.array_equal(got, want)


def test_image_b64_501_without_pil_and_400_on_garbage(monkeypatch):
    model = types.SimpleNamespace(wire_dtype=np.dtype("uint8"),
                                  input_shape=(32, 32, 1),
                                  task="classification")
    with pytest.raises(phttp.ServeError) as e:
        phttp.decode_pixels({"image_b64": "AA=="}, model)
    assert e.value.status == 400
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(phttp.ServeError) as e:
        phttp.decode_pixels({"image_b64": "AA=="}, model)
    assert e.value.status == 501


# -- tenant QoS --------------------------------------------------------------

QOS_SPECS = [
    jadmission.DEFAULT_QOS_SPEC,
    "premium:rate=0,shed_at=1.0,tenants=acme|bigco;"
    "best_effort:rate=20,burst=5,shed_at=0.5,always_big=1;"
    "default=best_effort",
]


def _drive_qos(mod, spec):
    qos = mod.TenantQoS.parse(spec)
    log = []
    for i in range(40):
        tenant = ("acme", "zed", "", "bigco")[i % 4]
        now = 100.0 + i * 0.01
        shed = qos.check_quota(tenant, now=now)
        log.append(None if shed is None else dataclasses.asdict(shed))
        shed = qos.check_pressure(tenant, i % 9, 8)
        log.append(None if shed is None else dataclasses.asdict(shed))
        qos.record_served(tenant, 0.001 * (i % 5), cache_hit=i % 3 == 0)
    classes = {n: dataclasses.asdict(c) for n, c in qos.classes.items()}
    return log, qos.stats(), classes, qos.default


@pytest.mark.parametrize("spec", QOS_SPECS)
def test_tenant_qos_matches_reference(spec):
    assert _drive_qos(padmission, spec) == _drive_qos(jadmission, spec)


def test_tenant_qos_refuses_bad_specs_like_reference():
    for bad in ("", "a:bogus=1", "a:rate=1;default=b"):
        with pytest.raises(ValueError) as want:
            jadmission.TenantQoS.parse(bad)
        with pytest.raises(ValueError) as got:
            padmission.TenantQoS.parse(bad)
        assert str(got.value) == str(want.value)


# -- response cache ----------------------------------------------------------


def test_response_cache_lru_matches_reference():
    p, j = pcache.ResponseCache(100), jcache.ResponseCache(100)
    assert pcache.payload_digest(b"abc") == jcache.payload_digest(b"abc")
    for cache in (p, j):
        keys = [cache.key("/v1/classify", "m", "d1", "uint8", "int8",
                          cache_digest) for cache_digest in "abcdef"]
        for i, k in enumerate(keys):
            cache.put(k, bytes(30 + i))
            cache.get(keys[0])
        cache.put(keys[1], bytes(500))  # larger than the budget: skipped
        cache.get(cache.key("/v1/detect", "m", "d1", "uint8", "int8", "a"))
    want = j.stats()
    got = p.stats()
    for key in ("entries", "bytes", "max_bytes", "hits", "misses",
                "hit_rate", "evictions", "insertions"):
        assert got[key] == want[key], key


def test_response_cache_hit_then_miss_after_reload(tmp_path):
    """The same payload answers from cache; after a reload promotes a new
    version (a new params digest) it misses and answers from the new
    weights."""
    from deep_vision_tpu_torch.cli import serve as cli

    workdir = str(tmp_path / "runs")
    write_step(f"{workdir}/lenet5", 1, lenet_model(1))
    args = cli.build_parser().parse_args(
        ["--models", "lenet5", "--workdir", workdir, "--wire-dtype",
         "float32", "--device", "cpu", "--port", "0", "--max-batch", "2",
         "--canary-frac", "1.0", "--canary-min-requests", "2",
         "--phase-timeout-s", "30", "--response-cache-mb", "4"])
    plane, server = cli.build_server(args)
    server.start_background()
    port = server.port
    body = {"pixels": images(1, seed=2)[0].tolist(), "top_k": 10}
    try:
        a = post(port, "/v1/classify", body)
        b = post(port, "/v1/classify", body)
        assert a[0] == b[0] == 200 and a[1] == b[1]
        assert "X-DVT-Cache" not in a[2] and b[2]["X-DVT-Cache"] == "hit"
        write_step(f"{workdir}/lenet5", 2, lenet_model(2))
        stop = threading.Event()

        def canary_traffic():
            k = 10
            while not stop.is_set():
                post(port, "/v1/classify",
                     {"pixels": images(1, seed=k)[0].tolist()})
                k += 1

        feeder = threading.Thread(target=canary_traffic, daemon=True)
        feeder.start()
        try:
            status, out, _ = post(port, "/v1/models/lenet5/reload",
                                  {"wait": True})
        finally:
            stop.set()
            feeder.join(30)
        assert status == 200 and out["version"]["state"] == "active"
        c = post(port, "/v1/classify", body)
        assert c[0] == 200 and "X-DVT-Cache" not in c[2]
        assert c[1] != a[1]
        d = post(port, "/v1/classify", body)
        assert d[1] == c[1] and d[2]["X-DVT-Cache"] == "hit"
        status, stats = get(port, "/v1/stats")
        assert stats["response_cache"]["hits"] == 2
    finally:
        server.shutdown()
        plane.stop()

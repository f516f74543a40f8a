"""``cli.serve --cascade`` and ``--brownout`` end to end over HTTP on the
CPU (mirrors the reference's tests/cascade_smoke.py and
tests/brownout_smoke.py at LeNet-5 size).

A three-tier classify cascade, lenet5_nano (int8, ``--cascade-quant-
front``) : lenet5 : lenet5_big, from port checkpoints of seeded weights.
Clients address lenet5_big with one image (so every tier's confidence
is the same number on every request, at bucket 1) and a per-request
field that keeps each body's cache key apart.  Seeded random tiers
rarely agree on top-1, so calibration runs on machinery, not quality:
``--cascade-min-agreement 0`` lets any observed agreement qualify.  The
checks: fail-closed all-big answers equal to the reference's
``CheckpointServingModel`` of lenet5_big (within 1e-4·max|ref|);
dual-run calibration flipping hop 0 to ``front`` (answers equal to the
front's own route); a front reload resetting hop 0 only, after which the
escalated-through traffic calibrates hop 1 to ``t1``; a mid reload
resetting hop 1 only; an always-big tenant pinned to ``big``; the
ladder pinned by ``POST /v1/brownout``: L1 pausing samples, L2 serving
``front`` below its threshold with ``X-DVT-Degraded`` to non-premium
tenants, L3 shedding the standard class 429 while premium answers.
Then the /metrics series, and the cascade and brownout renderers
byte-equal to the reference's on the same stats.  A second server
(lenet5 alone, ``--brownout``, a response cache) answers a repeated
payload at L2 after a reload with the retired version's bytes, marked
degraded, and at L3 sheds a standard tenant's request on its path
before parsing its body.
"""

import time

import numpy as np
import pytest

import _torch_zoo as tz
from _torch_serve import get, jax_lenet, post, write_step
from deep_vision_tpu.core.metrics import PromText as JaxPromText
from deep_vision_tpu.serve import http as jhttp
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.core.metrics import PromText
from deep_vision_tpu_torch.serve import http as phttp

pytestmark = [pytest.mark.models, pytest.mark.serve, pytest.mark.brownout]

NANO, MID, BIG = "lenet5_nano", "lenet5", "lenet5_big"
#: big-tier answers vs the JAX serving model (float32 compute)
BOUND = 1e-4
QOS = ("premium:rate=0,shed_at=1.0,always_big=1,tenants=acme;"
       "standard:rate=0,shed_at=0.5;default=standard")
PREMIUM = {"X-DVT-Tenant": "acme"}


def _args(workdir, *extra):
    return cli.build_parser().parse_args(
        ["--workdir", workdir, "--wire-dtype", "float32", "--device", "cpu",
         "--port", "0", "--max-batch", "4", "--canary-frac", "1.0",
         "--canary-min-requests", "2", "--canary-max-p99-ratio", "50",
         "--phase-timeout-s", "30", "--response-cache-mb", "1", "--warmup",
         "--brownout", "--brownout-force", "0", "--brownout-interval-ms",
         "20", *extra])


@pytest.fixture()
def cascade_server(tmp_path):
    workdir = str(tmp_path / "runs")
    variables = {n: tz.variables(n) for n in (NANO, MID, BIG)}
    for n, v in variables.items():
        write_step(f"{workdir}/{n}", 1, tz.port(n, v))
    plane, server = cli.build_server(_args(
        workdir, "--models", f"{NANO},{MID},{BIG}",
        "--cascade", f"{NANO}:{MID}:{BIG}", "--cascade-min-agreement", "0",
        "--cascade-sample-period", "3", "--cascade-min-sample", "4",
        "--cascade-topk", "3", "--cascade-quant-front", "--qos", QOS))
    server.start_background()
    yield plane, server, workdir, variables
    server.httpd.brownout.stop()
    server.shutdown()
    plane.stop()


class _Client:
    """Sequential requests to one path, each body with its own ``n``."""

    def __init__(self, port, img):
        self.port, self.pixels, self.n = port, img.tolist(), 0

    def __call__(self, model=BIG, headers=None, top_k=5):
        self.n += 1
        return post(self.port, f"/v1/models/{model}/classify",
                    {"pixels": self.pixels, "top_k": top_k, "n": self.n},
                    headers=headers)


def _cascade(port):
    return get(port, "/v1/stats")[1]["cascade"]


def _tiers(client, k, **kw):
    out = []
    for _ in range(k):
        status, body, headers = client(**kw)
        assert status == 200, body
        out.append((headers.get("X-DVT-Tier"),
                    headers.get("X-DVT-Degraded"), body))
    return out


def _reload(port, plane, client, name, step):
    """Reload ``name`` to ``step`` over HTTP, feeding its canary through
    its own route until the new version is active."""
    status, out, _ = post(port, f"/v1/models/{name}/reload",
                          {"force": True})
    assert status == 200 and out["status"] == "reloading", out
    t_end = time.monotonic() + 60
    while plane.active_version(name).version != step:
        assert time.monotonic() < t_end, plane.models()[name]
        status, body, _ = client(model=name)
        assert status == 200, body


def test_cascade_and_ladder_over_http(cascade_server):
    plane, server, workdir, variables = cascade_server
    port = server.port
    img = np.random.RandomState(3).randn(32, 32, 1).astype(np.float32)
    client = _Client(port, img)

    # fail closed: an uncalibrated chain answers everything from big
    cas = _cascade(port)
    assert cas["tiers"] == [NANO, MID, BIG] and len(cas["hops"]) == 2
    assert all(h["threshold"] is None for h in cas["hops"])
    _, models, = get(port, "/v1/models")
    entries = models["models"]
    assert entries[NANO]["cascade"]["role"] == "front"
    assert entries[NANO]["model"]["infer_dtype"] == "int8"
    assert entries[MID]["cascade"] == {
        "chain": f"{NANO}:{MID}:{BIG}", "tier": "t1", "role": "mid",
        "hop": 1, "threshold_source": "uncalibrated"}
    assert entries[BIG]["cascade"]["role"] == "big"
    ref = np.asarray(jax_lenet(variables[BIG], name=BIG).compile_bucket(1)(
        img[None]))[0]
    first = _tiers(client, 2)
    for tier, degraded, body in first:
        assert tier == "big" and degraded is None
        got = {t["class"]: t["logit"] for t in body["top"]}
        assert list(got) == [int(c) for c in np.argsort(-ref)[:5]]
        np.testing.assert_allclose([got[c] for c in got], ref[list(got)],
                                   rtol=0, atol=BOUND * np.abs(ref).max())

    # dual-run calibration flips hop 0; the front's answers are its own
    # route's (a direct request carries no tier header)
    seen = _tiers(client, 13)
    cas = _cascade(port)
    assert cas["hops"][0]["calibrated"] and not cas["hops"][1]["calibrated"]
    front = [body for tier, _, body in seen if tier == "front"]
    # after calibration only the sample slots (every third) answer big
    assert front and {t for t, _, _ in seen[-6:]} == {"front", "big"}
    status, direct, headers = client(model=NANO)
    assert status == 200 and "X-DVT-Tier" not in headers
    assert front[-1]["top"] == direct["top"][:5]
    assert len(direct["top"]) == 3  # the front tier answers its top-K rows

    # always-big tenants never leave the big tier
    forced = cas["forced_big"]
    assert {t for t, _, _ in _tiers(client, 3, headers=PREMIUM)} == {"big"}
    assert _cascade(port)["forced_big"] == forced + 3

    # a front reload resets hop 0 alone; hop 1's sample survives, and the
    # traffic escalated through calibrates hop 1 to serve "t1"
    hop1 = _cascade(port)["hops"][1]["samples"]
    write_step(f"{workdir}/{NANO}", 2, tz.port(NANO, tz.variables(NANO, 1)))
    _reload(port, plane, client, NANO, 2)
    cas = _cascade(port)
    assert cas["resets"] == 1 and cas["hops"][0]["threshold"] is None
    assert cas["hops"][1]["samples"] >= hop1
    seen = [t for t, _, _ in _tiers(client, 16)]
    assert "t1" in seen, seen
    cas = _cascade(port)
    assert cas["hops"][0]["calibrated"] and cas["hops"][1]["calibrated"]

    # a mid reload resets hop 1 alone
    write_step(f"{workdir}/{MID}", 2, tz.port(MID, tz.variables(MID, 1)))
    _reload(port, plane, client, MID, 2)
    cas = _cascade(port)
    assert cas["resets"] == 2
    assert cas["hops"][0]["calibrated"] and cas["hops"][1]["threshold"] is None
    assert cas["escalated_error"] == 0

    # the ladder, pinned over HTTP: L1 pauses the dual-run samples
    status, bo = post(port, "/v1/brownout", {"force": 1})[:2]
    assert status == 200 and bo["level"] == 1 and bo["forced"] == 1
    before = _cascade(port)
    _tiers(client, 6)
    after = _cascade(port)
    assert after["samples"] == before["samples"]
    assert after["samples_paused"] > before["samples_paused"]
    # L2: a request below hop 0's threshold is served "front", degraded,
    # to a standard tenant; premium goes to big
    router = server.httpd.cascade
    with router._lock:
        router.hops[0].threshold = 1.5  # above any confidence
    assert post(port, "/v1/brownout", {"force": 2})[1]["level"] == 2
    tier, degraded, _ = _tiers(client, 1)[0]
    assert (tier, degraded) == ("front", "1")
    tier, degraded, _ = _tiers(client, 1, headers=PREMIUM)[0]
    assert (tier, degraded) == ("big", None)
    assert _cascade(port)["degraded_served"] == 1
    # L3: the standard class sheds whatever the queue holds; premium not
    assert post(port, "/v1/brownout", {"force": 3})[1]["level"] == 3
    status, body, _ = client()
    assert status == 429 and "priority" in body["error"], body
    assert client(headers=PREMIUM)[0] == 200
    status, out = post(port, "/v1/brownout", {"force": None})[:2]
    assert status == 200 and out["forced"] is None
    assert post(port, "/v1/brownout", {"force": "x"})[0] == 400
    assert post(port, "/v1/brownout", {"level": 1})[0] == 400

    # /metrics: every series present and parseable
    status, text = get(port, "/metrics", text=True)
    assert status == 200
    for series in ("dvt_cascade_requests_total", "dvt_cascade_threshold",
                   "dvt_cascade_hop_agreement", 'tier="t1"',
                   "dvt_cascade_samples_paused_total",
                   "dvt_cascade_degraded_served_total",
                   "dvt_cascade_latency_seconds_bucket",
                   "dvt_brownout_level", "dvt_brownout_level_entries_total",
                   "dvt_serve_cache_tier_insertions_total",
                   "dvt_serve_cache_stale_hits_total"):
        assert series in text, series
    stats = get(port, "/v1/stats")[1]
    assert set(stats["response_cache"]["insertions_by_tier"]) >= {
        "front", "t1", "big"}
    assert stats["brownout"]["level_entries"]["L3"] == 1


def test_renderers_match_reference(cascade_server):
    """The cascade and brownout series, byte for byte the reference
    renderers' on the same stats, with hops calibrated and per-class
    thresholds in place."""
    plane, server, _, _ = cascade_server
    client = _Client(server.port, np.random.RandomState(3).randn(
        32, 32, 1).astype(np.float32))
    _tiers(client, 16)
    stats = get(server.port, "/v1/stats")[1]
    stats["cascade"]["hops"][0]["class_thresholds"] = {
        "3": 0.25, "1": None, "7": 0.75}
    for name in ("_render_cascade_metrics", "_render_brownout_metrics"):
        key = "cascade" if "cascade" in name else "brownout"
        mine, ref = PromText(), JaxPromText()
        getattr(phttp, name)(mine, stats[key])
        getattr(jhttp, name)(ref, stats[key])
        assert mine.render() == ref.render(), name
        assert mine.render().count("\n") > 10
    got = sorted(ln for ln in phttp.render_serve_metrics(stats).splitlines()
                 if ln.startswith(("dvt_cascade", "dvt_brownout",
                                   "dvt_serve_cache")))
    want = sorted(ln for ln in jhttp.render_serve_metrics(stats).splitlines()
                  if ln.startswith(("dvt_cascade", "dvt_brownout",
                                    "dvt_serve_cache")))
    assert got == want


def test_stale_cache_hit_at_l2(tmp_path):
    """At L2 a repeated payload whose version was retired answers the
    retired version's bytes, marked degraded; below L2 it misses."""
    workdir = str(tmp_path / "runs")
    write_step(f"{workdir}/{MID}", 1, tz.port(MID, tz.variables(MID)))
    plane, server = cli.build_server(_args(workdir, "--models", MID))
    server.start_background()
    try:
        port = server.port
        rng = np.random.RandomState(4)
        body = {"pixels": rng.randn(32, 32, 1).astype(np.float32).tolist()}
        s1, v1, h1 = post(port, f"/v1/models/{MID}/classify", body)
        assert s1 == 200 and "X-DVT-Degraded" not in h1
        assert post(port, f"/v1/models/{MID}/classify", body)[2].get(
            "X-DVT-Cache") == "hit"
        write_step(f"{workdir}/{MID}", 2, tz.port(MID, tz.variables(MID, 1)))
        other = _Client(port, rng.randn(32, 32, 1).astype(np.float32))
        _reload(port, plane, other, MID, 2)
        post(port, "/v1/brownout", {"force": 2})
        s2, v2, h2 = post(port, f"/v1/models/{MID}/classify", body)
        assert s2 == 200 and h2.get("X-DVT-Degraded") == "1"
        assert h2.get("X-DVT-Cache") == "hit" and v2 == v1
        post(port, "/v1/brownout", {"force": 0})
        s3, v3, h3 = post(port, f"/v1/models/{MID}/classify",
                          dict(body, n=1))
        assert s3 == 200 and "X-DVT-Degraded" not in h3 and v3 != v1
        stats = get(port, "/v1/stats")[1]
        assert stats["response_cache"]["stale_hits"] == 1
        assert stats["models"][MID]["engine"]["trace"]["slow_suppressed"] \
            == 0
    finally:
        server.httpd.brownout.stop()
        server.shutdown()
        plane.stop()


def test_shed_before_parse(tmp_path):
    """The path form sheds on the tenant header before its body is
    parsed (a departure from the reference, which parses first): at L3 a
    standard tenant's malformed body answers 429 and a premium tenant's
    400; ``/v1/classify`` names its model in the body and still parses
    first; a cached payload answers at L3 without a parse."""
    workdir = str(tmp_path / "runs")
    write_step(f"{workdir}/{MID}", 1, tz.port(MID, tz.variables(MID)))
    plane, server = cli.build_server(_args(workdir, "--models", MID,
                                           "--qos", QOS))
    server.start_background()
    try:
        port = server.port
        path = f"/v1/models/{MID}/classify"
        bad, other = b'{"pixels": [1, 2', {"model": BIG, "pixels": [0.0]}
        body = {"pixels": np.random.RandomState(5).randn(
            32, 32, 1).astype(np.float32).tolist()}
        status, out, _ = post(port, path, None, raw=bad)
        assert status == 400 and "bad JSON" in out["error"], out
        assert post(port, path, other)[0] == 400
        status, first, _ = post(port, path, body)
        assert status == 200
        assert post(port, "/v1/brownout", {"force": 3})[1]["level"] == 3
        status, out, _ = post(port, path, None, raw=bad)
        assert status == 429 and "priority" in out["error"], out
        assert post(port, path, other)[0] == 429
        status, out, _ = post(port, path, None, headers=PREMIUM, raw=bad)
        assert status == 400 and "bad JSON" in out["error"], out
        status, out, _ = post(port, "/v1/classify", None, raw=bad)
        assert status == 400 and "bad JSON" in out["error"], out
        status, out, headers = post(port, path, body)
        assert status == 200 and out == first
        assert headers.get("X-DVT-Cache") == "hit"
        assert post(port, path, dict(body, n=1))[0] == 429
        assert post(port, path, dict(body, n=1), headers=PREMIUM)[0] == 200
        shed = get(port, "/v1/stats")[1]["qos"]["standard"]["shed_priority"]
        assert shed == 3
    finally:
        server.httpd.brownout.stop()
        server.shutdown()
        plane.stop()


@pytest.mark.parametrize("argv,match", [
    (["-m", MID, "--cascade", f"{NANO}:{MID}"], "--models"),
    (["--models", f"{NANO},{MID}", "--cascade", f"{NANO}:{BIG}"],
     "not served"),
    (["--models", f"{MID},yolov3_toy", "--cascade", f"{MID}:yolov3_toy"],
     "one workload verb"),
    (["--models", f"{MID},hourglass_toy", "--cascade",
      f"hourglass_toy:{MID}"], "one workload verb"),
    (["--models", f"{MID},{BIG}", "--cascade", f"{MID}:{MID}"], "distinct"),
])
def test_cascade_build_checks(tmp_path, argv, match):
    args = cli.build_parser().parse_args(
        ["--workdir", str(tmp_path), "--device", "cpu", *argv])
    with pytest.raises(ValueError, match=match):
        cli.build_server(args)


def test_detect_cascade_over_http(tmp_path):
    """yolov3_toy : centernet_toy, both 64², so one request feeds both
    tiers: the escalation signal comes from the front's device-decoded
    rows, every answer is 200 with its tier, and a front answer's kept
    boxes equal the front's own route."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    front, big = "yolov3_toy", "centernet_toy"
    workdir = str(tmp_path / "runs")
    for i, name in enumerate((front, big)):
        gen = torch.Generator().manual_seed(i)
        write_step(f"{workdir}/{name}", 1,
                   get_config(name).model().reset_parameters(gen))
    plane, server = cli.build_server(_args(
        workdir, "--models", f"{front},{big}", "--cascade", f"{front}:{big}",
        "--cascade-min-agreement", "0", "--cascade-sample-period", "3",
        "--cascade-min-sample", "4", "--detect-score-threshold", "0.0"))
    server.start_background()
    try:
        port = server.port
        img = np.random.RandomState(5).rand(64, 64, 3).astype(np.float32)
        tiers = []
        for n in range(18):
            status, body, headers = post(
                port, f"/v1/models/{big}/detect",
                {"pixels": img.tolist(), "score_threshold": 0.0, "n": n})
            assert status == 200, body
            tiers.append((headers["X-DVT-Tier"], body))
        assert tiers[0][0] == "big" and {t for t, _ in tiers} == {"front",
                                                                   "big"}
        status, direct, headers = post(
            port, f"/v1/models/{front}/detect",
            {"pixels": img.tolist(), "score_threshold": 0.0})
        assert status == 200 and "X-DVT-Tier" not in headers
        got = next(b for t, b in reversed(tiers) if t == "front")
        assert got["detections"] == direct["detections"]
        assert got["num_detections"] > 0
        cas = get(port, "/v1/stats")[1]["cascade"]
        assert cas["hops"][0]["calibrated"] and cas["escalated_error"] == 0
    finally:
        server.httpd.brownout.stop()
        server.shutdown()
        plane.stop()

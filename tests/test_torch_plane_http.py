"""The control plane behind ``cli.serve --models`` over HTTP on the CPU,
against the JAX package (mirrors tests/test_models_plane.py's HTTP
cases).

Two models (LeNet-5 and LeNet-5-nano at full width) boot from port
checkpoints in ``<workdir>/<name>``, with a weight-cache budget between
the larger model's bytes and the two models' sum, so alternating
requests evict and re-admit.  The plane's answers are held against the
reference's ``CheckpointServingModel`` on the same weights, before and
after a hot reload to a new step under closed-loop clients (float32,
within 1e-4·max|ref|); the reload walks shadow (top-1 agreement) and
canary to ACTIVE and loses no request.  Then the lifecycle routes'
status codes, ``/metrics``, ``/v1/traces`` and ``/v1/drain``."""

import copy
import threading

import numpy as np
import pytest

import _torch_zoo as tz
from _torch_serve import get, images, jax_lenet, post, write_step
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.core.restore import params_digest
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import ModelRegistry

pytestmark = [pytest.mark.models, pytest.mark.serve]

#: plane answers vs the JAX serving model (float32 compute)
BOUND = 1e-4
MODELS = ("lenet5", "lenet5_nano")


def _step2_variables(variables):
    """Step 2's weights: step 1's with the classifier bias moved by a
    seeded offset about a constant shift, so answers change visibly
    (every logit moves) while top-1 mostly stays (the shadow gate
    compares top-1)."""
    v = copy.deepcopy(variables)
    bias = v["params"]["Dense_1"]["bias"]
    noise = np.random.RandomState(11).randn(*bias.shape) * 1e-3
    v["params"]["Dense_1"]["bias"] = (bias + 0.25 + noise).astype(np.float32)
    return v


@pytest.fixture()
def plane_server(tmp_path):
    workdir = str(tmp_path / "runs")
    variables = {name: tz.variables(name) for name in MODELS}
    sizes = {}
    for name in MODELS:
        model = tz.port(name, variables[name])
        sizes[name] = sum(t.numel() * t.element_size()
                          for t in model.state_dict().values())
        write_step(f"{workdir}/{name}", 1, model)
    budget_mb = (max(sizes.values()) + sum(sizes.values())) / 2 / 2**20
    args = cli.build_parser().parse_args(
        ["--models", ",".join(MODELS), "--workdir", workdir,
         "--wire-dtype", "float32", "--device", "cpu", "--port", "0",
         "--max-batch", "4", "--hbm-budget-mb", str(budget_mb),
         "--canary-frac", "0.5", "--canary-min-requests", "3",
         "--shadow-frac", "1.0", "--phase-timeout-s", "30",
         "--response-cache-mb", "1", "--warmup"])
    plane, server = cli.build_server(args)
    server.start_background()
    yield plane, server, workdir, variables, sizes
    server.shutdown()
    plane.stop()


def _logits(reply):
    return {t["class"]: t["logit"] for t in reply["top"]}


def _hold(replies, jsm, x):
    ref = np.asarray(jsm.compile_bucket(len(x))(x))
    bound = BOUND * np.abs(ref).max()
    for (status, body, _), row in zip(replies, ref):
        assert status == 200, body
        got = _logits(body)
        assert sorted(got) == list(range(10))
        np.testing.assert_allclose([got[c] for c in range(10)], row,
                                   rtol=0, atol=bound)


class _Clients:
    """Closed-loop HTTP clients on one model's path; every non-200 is a
    lost request."""

    def __init__(self, port, name, imgs, n=4):
        self.port, self.name, self.imgs = port, name, imgs
        self.stop = threading.Event()
        self.codes: list = []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True) for i in range(n)]
        for t in self.threads:
            t.start()

    def _run(self, i):
        k = i
        while not self.stop.is_set():
            img = self.imgs[k % len(self.imgs)]
            k += 1
            status, _, _ = post(self.port, f"/v1/models/{self.name}/classify",
                                {"pixels": img.tolist()})
            self.codes.append(status)

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(30)
            assert not t.is_alive()


def test_plane_answers_match_reference_across_a_reload(plane_server):
    plane, server, workdir, variables, _ = plane_server
    x = images(4, seed=3)
    body = [{"pixels": im.tolist(), "top_k": 10} for im in x]
    before = [post(server.port, "/v1/models/lenet5/classify", b)
              for b in body]
    _hold(before, jax_lenet(variables["lenet5"]), x)
    # a new step lands in the workdir while clients keep asking
    v2 = _step2_variables(variables["lenet5"])
    step2 = tz.port("lenet5", v2)
    write_step(f"{workdir}/lenet5", 2, step2)
    # distinct images: a repeated payload would answer from the response
    # cache and never reach the shadow or the canary
    clients = _Clients(server.port, "lenet5", images(256, seed=4))
    try:
        status, out, _ = post(server.port, "/v1/models/lenet5/reload",
                              {"wait": True})
    finally:
        clients.finish()
    assert status == 200 and out["status"] == "done", out
    v = out["version"]
    assert (v["version"], v["state"], v["step"]) == (2, "active", 2), v
    assert v["shadow"]["compared"] >= 10
    assert v["canary"]["requests"] >= 3 and v["canary"]["errors"] == 0
    assert clients.codes and set(clients.codes) == {200}
    status, listing = get(server.port, "/v1/models")
    entry = listing["models"]["lenet5"]
    assert entry["active_version"] == 2
    assert entry["model"]["params_digest"] == params_digest(step2)
    after = [post(server.port, "/v1/models/lenet5/classify", b)
             for b in body]
    _hold(after, jax_lenet(v2), x)
    # the old answers no longer hold: the reload changed what is served
    assert any(_logits(a[1]) != _logits(b[1])
               for a, b in zip(after, before))


def test_alternating_models_evict_and_readmit(plane_server):
    plane, server, _, _, sizes = plane_server
    cache = plane.cache
    assert max(sizes.values()) < cache.budget_bytes < sum(sizes.values())
    x = images(1, seed=5)[0]
    body = {"pixels": x.tolist(), "top_k": 10}

    def ask(name):
        # ?debug=1 bypasses the response cache, so every request runs
        status, reply, _ = post(server.port,
                                f"/v1/models/{name}/classify?debug=1", body)
        assert status == 200
        return reply["top"]

    first = {name: ask(name) for name in MODELS}
    compiles = {n: plane.active_engine(n).compiles for n in MODELS}
    evictions = cache.stats()["evictions"]
    for _ in range(3):
        for name in MODELS:
            assert ask(name) == first[name]
            assert cache.resident_models() == [name]
    st = cache.stats()
    assert st["evictions"] - evictions == 6 and st["misses"] >= 6
    assert {n: plane.active_engine(n).compiles for n in MODELS} == compiles


def test_lifecycle_routes_metrics_traces_and_drain(plane_server):
    plane, server, _, _, _ = plane_server
    port = server.port
    status, stats = get(port, "/v1/stats")
    assert status == 200
    assert set(stats) >= {"models", "cache", "plane", "response_cache",
                          "kernels"}
    status, reply, _ = post(port, "/v1/models/nope/reload", {})
    assert status == 404 and reply["error"].startswith("unknown model")
    assert post(port, "/v1/models/lenet5/promote", {})[0] == 409
    assert post(port, "/v1/models/lenet5/rollback", {})[0] == 409
    status, reply, _ = post(port, "/v1/models/lenet5/reload", {})
    assert status == 200 and reply["status"] == "no_new_step"
    # a name required when two models are served
    status, reply, _ = post(port, "/v1/classify",
                            {"pixels": images(1)[0].tolist()})
    assert status == 404 and "model name required" in reply["error"]
    status, reply, _ = post(port, "/v1/models/lenet5/classify",
                            {"pixels": images(1)[0].tolist(),
                             "model": "lenet5_nano"})
    assert status == 400 and "contradicts" in reply["error"]
    body = {"pixels": images(1, seed=8)[0].tolist()}
    a = post(port, "/v1/models/lenet5/classify", body)
    b = post(port, "/v1/models/lenet5/classify", body)
    assert a[1] == b[1] and b[2].get("X-DVT-Cache") == "hit"
    status, text = get(port, "/metrics", text=True)
    assert status == 200
    assert 'dvt_serve_model_up{model="lenet5",state="active",' \
           'version="1"} 1' in text
    for series in ("dvt_serve_weight_cache_hits_total",
                   "dvt_serve_reloads_total", "dvt_serve_cache_hits_total",
                   "dvt_serve_request_latency_seconds_bucket",
                   'dvt_serve_kernel_launches_total{kernel="serve_ingest"}'):
        assert series in text, series
    status, traces = get(port, "/v1/traces?n=2")
    assert status == 200 and len(traces["traces"]) == 2
    assert traces["summary"]["finished"] >= 2
    status, reply, _ = post(port, "/v1/drain", {"drain_deadline_s": 5})
    assert status == 200 and reply["status"] == "draining"
    assert get(port, "/v1/healthz") == (503, {"status": "draining",
                                             "models": list(MODELS)})
    status, reply, _ = post(port, "/v1/drain", {})
    assert reply["already_draining"] is True
    status, reply, _ = post(port, "/v1/models/lenet5/classify",
                            {"pixels": images(1, seed=9)[0].tolist()})
    assert status == 429 and "shutdown" in reply["error"]


def test_lifecycle_routes_need_the_plane():
    from _torch_serve import lenet_variables, port_lenet

    psm = port_lenet(lenet_variables())
    reg = ModelRegistry()
    reg.add(psm)
    eng = BatchingEngine(psm, buckets=[1]).start()
    srv = ServeServer(reg, {psm.name: eng}).start_background()
    try:
        status, reply, _ = post(srv.port, "/v1/models/lenet5/reload", {})
        assert status == 503 and "--models" in reply["error"]
        status, reply, _ = post(srv.port, "/v1/models/lenet5/classify",
                                {"pixels": images(1)[0].tolist()})
        assert status == 200 and len(reply["top"]) == 5
    finally:
        srv.shutdown()
        eng.stop()

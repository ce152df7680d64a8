"""The port's HTTP server, router and image-fed benchmark tool
(band_tpu_torch/tools/{server,router,benchmark}.py) on CPU workers and
tests/data models: the server's round trip (sync, async + /wait),
bad requests, hot swap (unregister, register again) and stats; the router
over two servers under both policies; the wire format shared with
band_tpu's server; the tool serving an image-fed config shaped like
configs/benchmark_image.json from a generated PNG.  Outputs are held
byte-equal to tests/data/torch_goldens.npz (TFLite) and, for the
image-fed tensors, to the TFLite interpreter on the same tensors."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import band_tpu_torch as tb
from band_tpu.tools import server as jserver
from band_tpu_torch.tools import benchmark as tbench
from band_tpu_torch.tools.router import serve_router
from band_tpu_torch.tools.server import decode_tensor, encode_tensor, serve
from tests.gen_torch_goldens import golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODEL = "effnetlite_int8"
MODEL_PATH = os.path.join(DATA, f"{MODEL}.tflite")
FC_PATH = os.path.join(DATA, "fc_int8.tflite")


def _cfg(dev_id=0, stuck_timeout_ms=0):
    return (
        tb.RuntimeConfigBuilder()
        .add_scheduler(tb.SchedulerType.FIXED_WORKER)
        .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                  device_ids=(dev_id,),
                                  stuck_timeout_ms=stuck_timeout_ms))
        .profile_warmups(0)
        .profile_runs(1)
        .build()
    )


def _goldens(name=MODEL):
    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    g = tb.Model.from_path(os.path.join(DATA, f"{name}.tflite")).graph
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    return golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                         len(want)), want


def _start(cfg):
    es, httpd = serve(cfg, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return es, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _call(url, method="GET", body=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def server():
    es, httpd, url = _start(_cfg())
    yield url
    httpd.shutdown()
    es.shutdown()


def test_server_round_trip(server):
    xs, want = _goldens()
    code, health = _call(f"{server}/health")
    assert code == 200 and health == {"status": "ok"}
    code, reg = _call(f"{server}/models", "POST", {"path": MODEL_PATH})
    assert code == 200
    mid = reg["model_id"]
    code, models = _call(f"{server}/models")
    entry = models[str(mid)]
    assert entry["name"] and entry["inputs"][0]["shape"] == [1, 64, 64, 3]
    assert entry["inputs"][0]["dtype"] == "int8"
    for i in range(3):
        code, out = _call(f"{server}/request", "POST",
                          {"model_id": mid, "inputs": [encode_tensor(xs[i])],
                           "sync": True})
        assert code == 200
        got = decode_tensor(out["outputs"][0])
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want[i])
    jobs = []
    for i in range(3, 8):
        code, out = _call(f"{server}/request", "POST",
                          {"model_id": mid, "inputs": [encode_tensor(xs[i])],
                           "sync": False})
        assert code == 200
        jobs.append((i, out["job_id"]))
    for i, jid in jobs:
        code, out = _call(f"{server}/wait", "POST",
                          {"job_id": jid, "timeout": 30})
        assert code == 200
        np.testing.assert_array_equal(decode_tensor(out["outputs"][0]),
                                      want[i])
    code, stats = _call(f"{server}/stats")
    assert code == 200 and stats["execution_counts"][str(mid)] >= 8
    assert stats["expected_latency_us"][str(mid)]


def test_server_bad_request(server):
    # every malformed request maps to a 400 JSON error, never a 500 or
    # a dropped connection
    code, resp = _call(f"{server}/request", "POST",
                       {"model_id": 99, "inputs": []})
    assert code == 400 and "error" in resp
    code, resp = _call(f"{server}/request", "POST", raw=b"not json")
    assert code == 400 and "invalid JSON" in resp["error"]
    code, resp = _call(f"{server}/request", "POST", raw=b"[1, 2, 3]")
    assert code == 400 and "JSON object" in resp["error"]
    code, resp = _call(
        f"{server}/request", "POST",
        raw=b'{"model_id": 0, "inputs": [{"shape": [2], "dtype": "float32",'
            b' "data": "AAAA"}]}')
    assert code == 400
    code, resp = _call(f"{server}/models", "POST",
                       {"path": "/nonexistent/model.tflite"})
    assert code == 400 and "register failed" in resp["error"]
    code, resp = _call(f"{server}/models", "POST", {})
    assert code == 400 and "missing 'path'" in resp["error"]
    code, resp = _call(f"{server}/wait", "POST", {"job_id": "x"})
    assert code == 400
    code, resp = _call(f"{server}/nowhere")
    assert code == 404


def test_server_unregister_and_register_again(server):
    """Hot swap: DELETE /models/<id>, then POST /models again, still
    serves right; /models and /stats list what is registered."""
    xs, want = _goldens("fc_int8")
    code, out = _call(f"{server}/models", "POST", {"path": FC_PATH})
    assert code == 200
    mid = out["model_id"]
    body = {"model_id": mid, "inputs": [encode_tensor(xs[0])]}
    code, out = _call(f"{server}/request", "POST", body)
    assert code == 200
    np.testing.assert_array_equal(decode_tensor(out["outputs"][0]), want[0])

    code, out = _call(f"{server}/models/{mid}", "DELETE")
    assert code == 200 and out["unregistered"] == mid
    code, models = _call(f"{server}/models")
    assert str(mid) not in models
    code, stats = _call(f"{server}/stats")
    assert str(mid) not in stats["expected_latency_us"]
    # further requests and double-unregister are clean 4xx
    code, out = _call(f"{server}/request", "POST", body)
    assert code == 400
    code, out = _call(f"{server}/models/{mid}", "DELETE")
    assert code == 404
    code, out = _call(f"{server}/models/notanid", "DELETE")
    assert code == 400

    code, out = _call(f"{server}/models", "POST", {"path": FC_PATH})
    assert code == 200 and out["model_id"] != mid
    mid2 = out["model_id"]
    code, out = _call(f"{server}/request", "POST",
                      {"model_id": mid2, "inputs": [encode_tensor(xs[1])]})
    assert code == 200
    np.testing.assert_array_equal(decode_tensor(out["outputs"][0]), want[1])
    code, models = _call(f"{server}/models")
    assert str(mid2) in models
    code, stats = _call(f"{server}/stats")
    assert stats["execution_counts"][str(mid2)] >= 1


def test_server_quarantined_worker_fails_explicitly():
    """A wedged (watchdog-quarantined) worker's jobs come back as
    explicit HTTP errors, not hangs."""
    es, httpd, base = _start(_cfg(stuck_timeout_ms=300))
    blocker = threading.Event()
    try:
        code, body = _call(base + "/models", "POST", {"path": FC_PATH})
        assert code == 200
        mid = body["model_id"]
        x = encode_tensor(np.zeros((1, 16, 16, 8), np.int8))
        w0 = es.engine.workers[0]
        orig = w0._dispatch

        def wedged(jobs, *a, **kw):
            blocker.wait(30.0)
            return orig(jobs, *a, **kw)

        w0._dispatch = wedged
        code, body = _call(base + "/request", "POST",
                           {"model_id": mid, "inputs": [x], "sync": False})
        assert code == 200
        code, body = _call(base + "/wait", "POST",
                           {"job_id": body["job_id"], "timeout": 15})
        assert code in (400, 504), (code, body)
        assert "error" in body
    finally:
        blocker.set()
        httpd.shutdown()
        es.shutdown()


def test_wire_format_matches_band_tpu():
    """The JSON tensor encoding is band_tpu's, both ways."""
    xs, _ = _goldens()
    for x in (xs[0], np.arange(6, dtype=np.float32).reshape(2, 3)):
        assert encode_tensor(x) == jserver.encode_tensor(x)
        np.testing.assert_array_equal(
            decode_tensor(jserver.encode_tensor(x)), x)
        np.testing.assert_array_equal(
            jserver.decode_tensor(encode_tensor(x)), x)


@pytest.fixture(scope="module")
def cluster():
    started = [_start(_cfg(dev)) for dev in (0, 1)]
    urls = [url for _, _, url in started]
    routers = {}
    for policy in ("round_robin", "least_loaded"):
        router, rhttpd = serve_router(urls, port=0, policy=policy)
        threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
        routers[policy] = (rhttpd, f"http://127.0.0.1:"
                                   f"{rhttpd.server_address[1]}")
    yield urls, {p: u for p, (_, u) in routers.items()}
    for rhttpd, _ in routers.values():
        rhttpd.shutdown()
    for es, httpd, _ in started:
        httpd.shutdown()
        es.shutdown()


def _executions(url):
    _, stats = _call(f"{url}/stats")
    return sum(stats["execution_counts"].values())


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_router_replicates_and_balances(cluster, policy):
    backends, routers = cluster
    rurl = routers[policy]
    code, h = _call(f"{rurl}/health")
    assert code == 200 and len(h["healthy"]) == 2
    code, reg = _call(f"{rurl}/models", "POST", {"path": MODEL_PATH})
    assert code == 200 and reg["replicas"] == 2
    xs, want = _goldens()
    before = [_executions(u) for u in backends]
    served = set()
    for i in range(8):
        code, out = _call(f"{rurl}/request", "POST",
                          {"model": f"{MODEL}.tflite",
                           "inputs": [encode_tensor(xs[i])]})
        assert code == 200
        served.add(out["served_by"])
        np.testing.assert_array_equal(decode_tensor(out["outputs"][0]),
                                      want[i])
    assert served == set(backends)
    # both backends took requests, by their own /stats
    after = [_executions(u) for u in backends]
    assert all(a > b for a, b in zip(after, before))
    assert sum(after) - sum(before) == 8
    code, stats = _call(f"{rurl}/stats")
    assert code == 200 and len(stats["backends"]) == 2
    assert stats["models"][f"{MODEL}.tflite"].keys() == {"0", "1"}


def test_router_unknown_model_and_bad_body(cluster):
    _, routers = cluster
    rurl = routers["least_loaded"]
    code, resp = _call(f"{rurl}/request", "POST",
                       {"model": "nope.tflite", "inputs": []})
    assert code == 503
    code, resp = _call(f"{rurl}/request", "POST", {"inputs": []})
    assert code == 400
    code, resp = _call(f"{rurl}/request", "POST", raw=b"[1]")
    assert code == 400


def test_image_fed_benchmark_tool(tmp_path):
    """A config shaped like configs/benchmark_image.json (without its
    absent reference files and its compilation_cache_dir) on a CPU
    worker: every request runs the preprocessing pipeline on a decoded
    PNG, and the pipeline's tensor served by the port equals the TFLite
    interpreter's output on it."""
    from PIL import Image

    from band_tpu_torch.buffer.synthetic import camera_frame

    png = tmp_path / "frame.png"
    Image.fromarray(camera_frame(77, 320, 240).array()).save(png)
    cfg = {
        "models": [{"graph": MODEL_PATH, "image": str(png),
                    "period_ms": 10, "batch_size": 1, "slo_us": 10_000_000}],
        "schedulers": ["shortest_expected_latency"],
        "workers": [{"device": "cpu", "device_ids": [0], "max_batch": 8}],
        "running_time_ms": 600,
        "profile_num_runs": 2,
        "execution_mode": "periodic",
    }
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(cfg))
    bench = tbench.Benchmark(tbench.BenchmarkConfig.from_json(str(path)))
    try:
        x = bench._request_inputs(0)[0]
        assert x.shape == (1, 64, 64, 3) and x.dtype == np.int8
        got = bench.engine.request_sync(bench.model_ids[0], [x])[0]
        report = bench.run()
    finally:
        bench.shutdown()
    m = report["model_0"]
    assert m["processed"] > 0 and m["canceled"] == 0
    assert m["slo_satisfaction"] == 1.0

    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=MODEL_PATH,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    np.testing.assert_array_equal(
        got, it.get_tensor(it.get_output_details()[0]["index"]))

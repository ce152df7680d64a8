"""HTTP serving front-end.

A port of band_tpu/tools/server.py, with the same routes and wire
format, so a client of either package talks to the other.  The
reference exposes C/Java bindings for embedding; a serving tier wants a
network front-end instead.  This is a small threaded HTTP/JSON server
over the engine (wire format JSON + base64 ndarray; a gRPC front-end
with the same surface lives in grpc_server.py):

  GET    /health            -> {"status": "ok"}
  GET    /models            -> model table (ids, inputs, outputs)
  POST   /models            -> {"path": "/path/model.tflite"} registers
  DELETE /models/<id>       -> unregister (hot swap; safe drain)
  POST   /request           -> {"model_id": 0, "inputs": [tensor...],
                               "slo_us": optional, "sync": true}
       tensor = {"shape": [...], "dtype": "uint8", "b64": "..."}
  POST   /wait              -> {"job_id": N, "timeout": s} fetches an
                               async request's outputs
  GET    /stats             -> execution counts + profiled latencies

Usage: python -m band_tpu_torch.tools.server --config cfg.json --port 8500

The config's workers name the devices: a ``gpu`` worker serves on a
CUDA card and fails to start without one; only a ``cpu`` worker serves
on the host.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..common import RequestOption
from ..config import RuntimeConfig, config_from_json
from ..errors import BandError, DeadlineExceeded
from ..ir.model import Model
from ..runtime.engine import Engine


def encode_tensor(arr: np.ndarray) -> Dict:
    arr = np.ascontiguousarray(arr)
    return {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_tensor(d: Dict) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


class EngineServer:
    def __init__(self, config: RuntimeConfig):
        self.engine = Engine.create(config)
        self._lock = threading.Lock()

    # --- handlers ---
    def handle(self, method: str, path: str, body: Optional[dict]):
        if method == "GET" and path == "/health":
            return 200, {"status": "ok"}
        if method == "GET" and path == "/models":
            return 200, self._models()
        if method == "POST" and path == "/models":
            return self._register(body or {})
        if method == "POST" and path == "/request":
            return self._request(body or {})
        if method == "POST" and path == "/wait":
            return self._wait(body or {})
        if method == "DELETE" and path.startswith("/models/"):
            return self._unregister(path[len("/models/"):])
        if method == "GET" and path == "/stats":
            return self._stats()
        return 404, {"error": f"no route {method} {path}"}

    def _wait(self, body: dict):
        """Fetch an async request's outputs: {"job_id": N, "timeout": s}."""
        try:
            jid = int(body["job_id"])
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": f"bad request: {e}"}
        try:
            outs = self.engine.wait(
                jid, timeout=float(body.get("timeout", 60))
            )
        except TimeoutError:
            return 504, {"error": "timeout"}
        except DeadlineExceeded:
            return 504, {"error": "slo_violation"}
        except (BandError, ValueError, TypeError) as e:
            return 400, {"error": str(e)}
        return 200, {"outputs": [encode_tensor(o) for o in outs]}

    def _unregister(self, model_id_s: str):
        try:
            mid = int(model_id_s)
        except ValueError:
            return 400, {"error": f"bad model id {model_id_s!r}"}
        try:
            with self._lock:
                self.engine.unregister_model(mid)
        except BandError as e:
            return 404, {"error": str(e)}
        return 200, {"unregistered": mid}

    def _models(self):
        out = {}
        # engine-lock-consistent snapshot (Engine.list_models)
        for mid, rec in self.engine.list_models().items():
            g = rec.model.graph
            out[mid] = {
                "name": rec.model.name,
                "inputs": [
                    {
                        "index": t,
                        "shape": list(g.tensor(t).shape),
                        "dtype": str(g.tensor(t).dtype),
                    }
                    for t in g.inputs
                ],
                "outputs": [
                    {
                        "index": t,
                        "shape": list(g.tensor(t).shape),
                        "dtype": str(g.tensor(t).dtype),
                    }
                    for t in g.outputs
                ],
                "worker": rec.worker_id,
                "subgraphs": len(rec.subgraph_keys),
            }
        return out

    def _register(self, body: dict):
        path = body.get("path")
        if not path:
            return 400, {"error": "missing 'path'"}
        try:
            with self._lock:
                mid = self.engine.register_model(
                    Model.from_path(path),
                    target_worker=body.get("target_worker", -1),
                )
        except (OSError, BandError, ValueError, TypeError) as e:
            return 400, {"error": f"register failed: {e}"}
        return 200, {"model_id": mid}

    def _request(self, body: dict):
        try:
            mid = int(body["model_id"])
            inputs = [decode_tensor(t) for t in body["inputs"]]
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": f"bad request: {e}"}
        option = RequestOption(
            slo_us=int(body.get("slo_us", -1)),
            slo_scale=float(body.get("slo_scale", -1.0)),
            target_worker=int(body.get("target_worker", -1)),
        )
        if not body.get("sync", True):
            try:
                jid = self.engine.request_async(mid, inputs, option)
            except (BandError, ValueError, TypeError) as e:
                return 400, {"error": str(e)}
            return 200, {"job_id": jid}  # fetch via POST /wait
        try:
            outs = self.engine.request_sync(
                mid, inputs, option, timeout=float(body.get("timeout", 60))
            )
        except DeadlineExceeded:
            return 504, {"error": "slo_violation"}
        except (BandError, ValueError, TypeError) as e:
            return 400, {"error": str(e)}
        return 200, {"outputs": [encode_tensor(o) for o in outs]}

    def _stats(self):
        counts = self.engine.get_model_execution_counts()
        latency = {}
        for mid, rec in self.engine.list_models().items():
            latency[mid] = {
                str(k): self.engine.get_expected_latency(k)
                for k in rec.subgraph_keys
            }
        return 200, {"execution_counts": counts, "expected_latency_us": latency}

    def shutdown(self):
        self.engine.shutdown()


def make_handler(server: EngineServer):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                code, payload = server.handle("GET", self.path, None)
            except Exception as e:  # the API boundary never drops a conn
                code, payload = 500, {"error": repr(e)}
            self._send(code, payload)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n) or b"{}"
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._send(400, {"error": f"invalid JSON: {e}"})
                    return
                if not isinstance(body, dict):
                    self._send(400, {"error": "body must be a JSON object"})
                    return
                code, payload = server.handle("POST", self.path, body)
            except Exception as e:
                code, payload = 500, {"error": repr(e)}
            self._send(code, payload)

        def do_DELETE(self):
            try:
                code, payload = server.handle("DELETE", self.path, None)
            except Exception as e:
                code, payload = 500, {"error": repr(e)}
            self._send(code, payload)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(config: RuntimeConfig, port: int = 8500):
    es = EngineServer(config)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(es))
    return es, httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--port", type=int, default=8500)
    args = ap.parse_args(argv)
    es, httpd = serve(config_from_json(args.config), args.port)
    print(f"band-tpu-torch serving on :{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        es.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

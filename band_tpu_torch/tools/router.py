"""Multi-host request router.

A copy of band_tpu/tools/router.py (it imports no engine, so it fronts
servers of either package).  The cross-host serving tier (SURVEY §5.8:
the reference is single process; a serving build owes a host-level
routing plane).  A thin
front-door that spreads requests over per-host engine servers
(tools/server.py) with pluggable balancing:

 * round_robin — rotate hosts
 * least_loaded — pick the host with the fewest in-flight requests
   (the router's own counter; the host-side planner still does
   SLO-aware scheduling among its local workers)

Backends are plain HTTP endpoints, so a "host" can be another machine
across DCN or another process on this one.

Usage: python -m band_tpu_torch.tools.router --port 8600 \
          --backend http://host1:8500 --backend http://host2:8500
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


class Backend:
    RETRY_AFTER_S = 10.0  # cooldown before an unhealthy backend is retried

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.inflight = 0
        self._unhealthy_since: Optional[float] = None
        self.lock = threading.Lock()

    @property
    def healthy(self) -> bool:
        # a failure sidelines the backend only for a cooldown window;
        # the next pick after that re-probes it (transient timeouts must
        # not evict a replica forever)
        t0 = self._unhealthy_since
        return t0 is None or (time.monotonic() - t0) > self.RETRY_AFTER_S

    def mark_healthy(self) -> None:
        self._unhealthy_since = None

    def call(self, method: str, path: str, body: Optional[dict],
             timeout: float = 120.0) -> Tuple[int, dict]:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.url + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                payload = resp.read()
                self.mark_healthy()
                return resp.status, json.loads(payload)
        except urllib.error.HTTPError as e:
            # an HTTP error is still a live backend; tolerate non-JSON
            # bodies (proxies answer with HTML)
            raw = e.read() or b"{}"
            try:
                payload = json.loads(raw)
            except json.JSONDecodeError:
                payload = {"error": raw.decode("utf-8", "replace")[:500]}
            return e.code, payload
        except Exception as e:
            self._unhealthy_since = time.monotonic()
            return 502, {"error": f"backend {self.url} unreachable: {e}"}


class Router:
    def __init__(self, backends: List[str], policy: str = "least_loaded"):
        self.backends = [Backend(u) for u in backends]
        self.policy = policy
        self._rr = itertools.cycle(range(len(self.backends)))
        # model registry: model name -> {backend_index: backend model_id}
        self.models: Dict[str, Dict[int, int]] = {}
        self._lock = threading.Lock()

    # --- backend selection ---
    def _pick(self, model: str) -> Optional[int]:
        candidates = [
            i
            for i, b in enumerate(self.backends)
            if b.healthy and model in self.models and i in self.models[model]
        ]
        if not candidates:
            return None
        if self.policy == "round_robin":
            for _ in range(len(self.backends)):
                i = next(self._rr)
                if i in candidates:
                    return i
            return candidates[0]
        # least_loaded with rotating tie-break so idle clusters still
        # spread load instead of hammering backend 0
        start = next(self._rr)
        n = len(self.backends)
        return min(
            candidates,
            key=lambda i: (self.backends[i].inflight, (i - start) % n),
        )

    # --- API ---
    def register(self, body: dict) -> Tuple[int, dict]:
        """Register the model on every healthy backend."""
        path = body.get("path")
        if not path:
            return 400, {"error": "missing 'path'"}
        name = path.rsplit("/", 1)[-1]
        entry: Dict[int, int] = {}
        for i, b in enumerate(self.backends):
            code, resp = b.call("POST", "/models", body)
            if code == 200:
                entry[i] = resp["model_id"]
        if not entry:
            return 502, {"error": "no backend accepted the model"}
        with self._lock:
            self.models[name] = entry
        return 200, {"model": name, "replicas": len(entry)}

    def request(self, body: dict) -> Tuple[int, dict]:
        model = body.get("model")
        if model is None:
            return 400, {"error": "missing 'model' (name registered via "
                                  "/models)"}
        i = self._pick(model)
        if i is None:
            return 503, {"error": f"no healthy backend serves {model}"}
        b = self.backends[i]
        payload = dict(body)
        payload.pop("model", None)
        payload["model_id"] = self.models[model][i]
        with b.lock:
            b.inflight += 1
        try:
            code, resp = b.call("POST", "/request", payload)
        finally:
            with b.lock:
                b.inflight -= 1
        if code == 200:
            resp["served_by"] = b.url
        return code, resp

    def stats(self) -> Tuple[int, dict]:
        return 200, {
            "backends": [
                {"url": b.url, "healthy": b.healthy, "inflight": b.inflight}
                for b in self.backends
            ],
            "models": {
                name: {str(i): mid for i, mid in entry.items()}
                for name, entry in self.models.items()
            },
        }

    def health(self) -> Tuple[int, dict]:
        for b in self.backends:
            code, _ = b.call("GET", "/health", None, timeout=5)
            if code == 200:
                b.mark_healthy()  # call() already marked failures
        return 200, {
            "healthy": [b.url for b in self.backends if b.healthy],
            "unhealthy": [b.url for b in self.backends if not b.healthy],
        }


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._send(*router.health())
            elif self.path == "/stats":
                self._send(*router.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"invalid JSON: {e}"})
                return
            if not isinstance(body, dict):
                self._send(400, {"error": "body must be a JSON object"})
                return
            if self.path == "/models":
                self._send(*router.register(body))
            elif self.path == "/request":
                self._send(*router.request(body))
            else:
                self._send(404, {"error": "not found"})

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve_router(backends: List[str], port: int = 8600,
                 policy: str = "least_loaded"):
    router = Router(backends, policy)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(router))
    return router, httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", action="append", required=True)
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--policy", default="least_loaded",
                    choices=["least_loaded", "round_robin"])
    args = ap.parse_args(argv)
    router, httpd = serve_router(args.backend, args.port, args.policy)
    print(f"band-tpu-torch router on :{args.port} -> {args.backend}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Minimal HTTP front-end over SamplerService (the port's copy of
srewd_tpu/serving/http.py; stdlib and numpy only — serving needs exactly
three endpoints).

POST /v1/super_resolve
    {"lr": [[[[..]]]], "months": [..]}                nested-list payload, or
    {"lr_b64": "<base64 of np.save bytes>", "months": [..]}   (efficient)
    -> {"sr": [...]} | {"sr_b64": "..."}  (mirrors the request encoding)
GET /healthz   -> {"ok": true}
GET /v1/stats  -> SamplerService.stats()

ThreadingHTTPServer gives one thread per in-flight request; concurrent
requests coalesce inside SamplerService into full device batches, so HTTP
concurrency turns into full batches on the card. A ValueError from
submit() (the client's input) is answered 400, any other failure 500.
"""

from __future__ import annotations

import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _b64_encode(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _b64_decode(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


def make_server(service, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks a free port."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: service.stats() is the signal
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/super_resolve":
                return self._json(404, {"error": f"unknown path {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if "lr_b64" in req:
                    lr, b64 = _b64_decode(req["lr_b64"]), True
                else:
                    lr, b64 = np.asarray(req["lr"], np.float32), False
                months = np.asarray(req["months"], np.int32)
            except Exception as e:
                return self._json(400, {"error": f"bad request: {e}"})
            try:
                sr = service.super_resolve(lr, months)
            except ValueError as e:
                # submit()'s input validation (bad lr rank, months length or
                # field-shape mismatch) is the CLIENT's fault, not a 5xx
                return self._json(400, {"error": f"bad request: {e}"})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            self._json(200, {"sr_b64": _b64_encode(sr)} if b64 else {"sr": sr.tolist()})

    return ThreadingHTTPServer((host, port), Handler)

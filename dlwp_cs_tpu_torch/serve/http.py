"""Stdlib HTTP front end for :class:`~dlwp_cs_tpu_torch.serve.service.ForecastService`.

The counterpart of ``dlwp_cs_tpu.serve.http``: the same routes, npz
payloads and status codes.  An ensemble request's ``seed`` seeds the
service's CPU ``torch.Generator`` (the reference: a JAX key), so the same
seed draws other members than the reference's.

Endpoints (payloads are ``numpy.savez`` archives — no extra deps, exact
dtypes, streams well):

* ``GET /healthz`` → ``{"status": "ok"}``
* ``GET /info`` → model/grid/variable metadata + serving stats (JSON)
* ``POST /forecast`` — request npz with arrays ``window`` ``(T_in, 6, n, n,
  C)`` raw fields, ``t0_days`` scalar, ``steps`` scalar int, optional
  ``normalized`` scalar bool; response npz with ``fields`` ``(1, steps*T_out,
  6, n, n, C)``, ``lead_hours``, ``init_times``.
* ``POST /ensemble`` — same request plus ``members`` scalar int, optional
  ``amplitude`` (scalar or per-variable), ``seed`` scalar int,
  ``keep_members`` scalar bool; response npz with ``mean``/``spread``
  (``(1, steps*T_out, 6, n, n, C)``), ``lead_hours``, ``init_times``, and
  ``members`` when kept.

Concurrent ``/forecast`` and ``/ensemble`` POSTs coalesce on the service's
micro-batcher: the server is threaded, each handler blocks on its request's
future while the batcher groups same-config requests into one device
dispatch (ensemble members additionally fold into the batch axis).
Backpressure: a full batcher queue returns **503**, a request that expires
in the queue returns **504**, and server-side ``steps``/``members`` caps
reject oversized requests with **400** — one client cannot trigger an
unbounded allocation/compile on a shared endpoint.

Client helpers: :func:`forecast_request`, :func:`ensemble_request` (use
``http.client``; work against any host/port, no third-party HTTP stack).
Under a device mesh the server runs on rank 0 of a
:class:`~dlwp_cs_tpu_torch.serve.service.ForecastService` front end while
the other ranks sit in ``follow()``; ``stop()`` closes the service, which
ends their ``follow()``.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = [
    "ForecastHTTPServer",
    "ensemble_request",
    "forecast_request",
    "serve_forever",
]


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _error_code(e: Exception) -> int:
    """Map service errors to HTTP codes: shed load (503), queue expiry
    (504), everything else a client error (400)."""
    from dlwp_cs_tpu_torch.serve.service import RequestTimeout, ServiceOverloaded

    if isinstance(e, ServiceOverloaded):
        return 503
    if isinstance(e, RequestTimeout):
        return 504
    return 400


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # set by ForecastHTTPServer
    service = None
    max_body = 1 << 30

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj):
        if code >= 400:
            # the request body may be partially/entirely unread (bad
            # Content-Length, oversized payload): keeping the HTTP/1.1
            # connection alive would desync the stream, so close it
            self.close_connection = True
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path == "/healthz":
            return self._reply_json(200, {"status": "ok"})
        if self.path == "/info":
            svc = self.service
            st = svc.stats
            payload = dict(svc.info())
            payload["stats"] = {
                "requests": st.requests,
                "batches": st.batches,
                "mean_batch": st.mean_batch,
                "padded_members": st.padded_members,
                "padded_mesh": st.padded_mesh,
                "dispatch_seconds": st.dispatch_seconds,
            }
            return self._reply_json(200, payload)
        return self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path == "/ensemble":
            return self._do_ensemble()
        if self.path != "/forecast":
            return self._reply_json(404, {"error": f"unknown path {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= self.max_body:
                raise ValueError(f"bad Content-Length {length}")
            with np.load(io.BytesIO(self.rfile.read(length))) as z:
                window = z["window"]
                t0_days = float(z["t0_days"])
                steps = int(z["steps"])
                normalized = bool(z["normalized"]) if "normalized" in z else False
        except Exception as e:  # noqa: BLE001 — malformed request
            return self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
        try:
            fc = self.service.submit(
                window, t0_days, steps=steps, normalized=normalized
            ).result()
        except Exception as e:  # noqa: BLE001 — model/shape errors
            return self._reply_json(
                _error_code(e), {"error": f"{type(e).__name__}: {e}"}
            )
        body = _npz_bytes(
            fields=np.asarray(fc.fields, np.float32),
            lead_hours=np.asarray(fc.lead_hours, np.float64),
            init_times=np.asarray(fc.init_times, np.float64),
        )
        self._reply(200, body, "application/octet-stream")

    def _do_ensemble(self):
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= self.max_body:
                raise ValueError(f"bad Content-Length {length}")
            with np.load(io.BytesIO(self.rfile.read(length))) as z:
                window = z["window"]
                t0_days = float(z["t0_days"])
                steps = int(z["steps"])
                members = int(z["members"])
                amplitude = np.asarray(z["amplitude"]) if "amplitude" in z else 0.05
                seed = int(z["seed"]) if "seed" in z else 0
                keep = bool(z["keep_members"]) if "keep_members" in z else False
                normalized = bool(z["normalized"]) if "normalized" in z else False
        except Exception as e:  # noqa: BLE001 — malformed request
            return self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
        if not hasattr(self.service, "_ensemble_batch"):
            return self._reply_json(
                400,
                {"error": "this service does not support /ensemble "
                          "(exported-artifact backends serve /forecast only)"},
            )
        try:
            if window.ndim == 6 and window.shape[0] != 1:
                # explicit multi-window batch: direct dispatch
                import torch

                fc = self.service.forecast_ensemble(
                    window, t0_days, steps=steps, members=members,
                    amplitude=amplitude,
                    generator=torch.Generator().manual_seed(seed),
                    keep_members=keep, normalized=normalized,
                )
            else:
                # through the micro-batcher: same-config requests coalesce
                # into one folded dispatch instead of serializing on a lock
                fc = self.service.submit_ensemble(
                    window, t0_days, steps=steps, members=members,
                    amplitude=amplitude, seed=seed,
                    keep_members=keep, normalized=normalized,
                ).result()
        except Exception as e:  # noqa: BLE001 — model/shape errors
            return self._reply_json(
                _error_code(e), {"error": f"{type(e).__name__}: {e}"}
            )
        arrays = {
            "mean": np.asarray(fc.mean, np.float32),
            "spread": np.asarray(fc.spread, np.float32),
            "lead_hours": np.asarray(fc.lead_hours, np.float64),
            "init_times": np.asarray(fc.init_times, np.float64),
        }
        if fc.members is not None:
            arrays["members"] = np.asarray(fc.members, np.float32)
        self._reply(200, _npz_bytes(**arrays), "application/octet-stream")


class ForecastHTTPServer:
    """Threaded HTTP server bound to a ForecastService.

    ``ForecastHTTPServer(service, port=0).start()`` → serve in a background
    thread (``.port`` reports the bound port); ``.stop()`` shuts down.
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False):
        handler = type("BoundHandler", (_Handler,), {"service": service})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.verbose = verbose
        self._httpd.daemon_threads = True
        self.service = service
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ForecastHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="forecast-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.service.close()


def serve_forever(service, host: str = "0.0.0.0", port: int = 8800,
                  verbose: bool = True):
    """Blocking entry point for a deployment."""
    srv = ForecastHTTPServer(service, host=host, port=port, verbose=verbose)
    print(f"[serve] listening on {host}:{srv.port}", flush=True)
    try:
        srv._httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv._httpd.server_close()
        service.close()


def forecast_request(host: str, port: int, window, t0_days: float,
                     steps: int, *, normalized: bool = False,
                     timeout: float = 300.0):
    """Client helper: POST one window, return (fields, lead_hours,
    init_times) numpy arrays."""
    body = _npz_bytes(
        window=np.asarray(window, np.float32),
        t0_days=np.float64(t0_days),
        steps=np.int64(steps),
        normalized=np.bool_(normalized),
    )
    with np.load(io.BytesIO(_post(host, port, "/forecast", body, timeout))) as z:
        return z["fields"], z["lead_hours"], z["init_times"]


def ensemble_request(host: str, port: int, window, t0_days: float,
                     steps: int, members: int, *, amplitude=0.05,
                     seed: int = 0, keep_members: bool = False,
                     normalized: bool = False, timeout: float = 300.0):
    """Client helper: POST one ensemble request, return a dict of numpy
    arrays (``mean``, ``spread``, ``lead_hours``, ``init_times``, and
    ``members`` when requested)."""
    body = _npz_bytes(
        window=np.asarray(window, np.float32),
        t0_days=np.float64(t0_days),
        steps=np.int64(steps),
        members=np.int64(members),
        amplitude=np.asarray(amplitude, np.float32),
        seed=np.int64(seed),
        keep_members=np.bool_(keep_members),
        normalized=np.bool_(normalized),
    )
    with np.load(io.BytesIO(_post(host, port, "/ensemble", body, timeout))) as z:
        return {k: z[k] for k in z.files}


def _post(host: str, port: int, path: str, body: bytes,
          timeout: float) -> bytes:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(
            "POST", path, body=body,
            headers={"Content-Type": "application/octet-stream"},
        )
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(
                f"{path} request failed ({resp.status}): {data[:500]!r}"
            )
        return data
    finally:
        conn.close()

"""Client for the HTTP serving host (serve_http.py) — stdlib + numpy only.
A copy of ``multimodal_auv_tpu/serve_client.py``: the protocol is the same.

A deployment's consumers shouldn't each re-derive the npz wire format;
this is the reference implementation of the protocol:

    from multimodal_auv_torch.serve_client import ServeClient

    c = ServeClient("http://gpu-host:8471")
    c.healthz()                      # liveness + artifact summary
    out = c.predict(main_u8, bathy_u8, sss_u8)          # fresh draws
    out = c.predict(main_u8, bathy_u8, sss_u8, seed=7)  # reproducible
    out["predicted"], out["predictive_uncertainty"], ...

Inputs are uint8 NHWC arrays (n, S, S, 3/3/1) — exactly what the packed
loader produces (data/packing.py); any row count is accepted (the server
pads/chunks). ``predict_rows`` yields the reference CSV schema row dicts
(inference/predictors.py:33's columns) for drop-in ledger writing.
"""
from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Iterator, Optional

import numpy as np

#: reference CSV header (predictors.py:33) — keys of predict_rows dicts
CSV_COLUMNS = ("Image Name", "Predicted Class", "Predictive Uncertainty",
               "Aleatoric Uncertainty")


class ServeError(RuntimeError):
    """Server returned an error status; ``.status`` and ``.detail``."""

    def __init__(self, status: int, detail: str):
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class ServeClient:
    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing -------------------------------------------------------------

    def _get(self, path: str):
        try:
            with urllib.request.urlopen(self.base_url + path,
                                        timeout=self.timeout) as r:
                body = r.read()
        except urllib.error.HTTPError as e:
            raise ServeError(e.code, _error_detail(e)) from e
        return json.loads(body)

    def _post(self, path: str, body: bytes):
        req = urllib.request.Request(self.base_url + path, data=body,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise ServeError(e.code, _error_detail(e)) from e

    # -- API ------------------------------------------------------------------

    def healthz(self) -> dict:
        return self._get("/healthz")

    def meta(self) -> dict:
        return self._get("/meta")

    def metrics_text(self) -> str:
        """Raw Prometheus exposition (text, not JSON)."""
        try:
            with urllib.request.urlopen(self.base_url + "/metrics",
                                        timeout=self.timeout) as r:
                return r.read().decode()
        except urllib.error.HTTPError as e:
            raise ServeError(e.code, _error_detail(e)) from e

    def predict(self, main_u8, bathy_u8, sss_u8, *,
                seed: Optional[int] = None) -> dict:
        """One request. Returns the server's JSON with array fields
        converted back to numpy: predicted (int64), predictive/aleatoric
        uncertainty (float64), mean_prob (n, C)."""
        arrays = {"main": np.asarray(main_u8), "bathy": np.asarray(bathy_u8),
                  "sss": np.asarray(sss_u8)}
        for k, a in arrays.items():
            if a.dtype != np.uint8:
                raise ValueError(f"{k} must be uint8 (got {a.dtype}); "
                                 "decode-once rule: normalization happens "
                                 "on-chip")
        if seed is not None:
            arrays["seed"] = np.uint32(seed)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        out = self._post("/predict", buf.getvalue())
        for k in ("predicted", "predictive_uncertainty",
                  "aleatoric_uncertainty", "mean_prob"):
            out[k] = np.asarray(out[k])
        return out

    def predict_rows(self, names, main_u8, bathy_u8, sss_u8, *,
                     seed: Optional[int] = None) -> Iterator[dict]:
        """Yield one reference-schema CSV row dict per sample
        (CSV_COLUMNS keys) — what engine/predict.py writes, over the wire."""
        out = self.predict(main_u8, bathy_u8, sss_u8, seed=seed)
        for i, name in enumerate(names):
            yield {
                "Image Name": name,
                "Predicted Class": int(out["predicted"][i]),
                "Predictive Uncertainty":
                    float(out["predictive_uncertainty"][i]),
                "Aleatoric Uncertainty":
                    float(out["aleatoric_uncertainty"][i]),
            }


def _error_detail(e: urllib.error.HTTPError) -> str:
    try:
        return json.loads(e.read()).get("error", "")
    except Exception:
        return ""

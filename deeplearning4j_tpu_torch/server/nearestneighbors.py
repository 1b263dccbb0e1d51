"""Nearest-neighbors HTTP server
(ref: deeplearning4j-nearestneighbor-server —
server/NearestNeighborsServer.java (Play HTTP server exposing VPTree
k-NN), server/NearestNeighbor.java (the search op),
model/{NearestNeighborRequest,NearestNeighborsResult(s),Base64NDarrayBody}.java).

The reference serves POST /knn (k-NN of a stored point by index) and
POST /knnnew (k-NN of a base64-serialized NDArray payload).  Same
endpoints here over http.server; arrays travel as base64-encoded raw
float32 bytes plus shape — the Base64NDarrayBody analog."""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree


def ndarray_to_base64(arr: np.ndarray) -> dict:
    """Base64NDarrayBody analog (ref: model/Base64NDarrayBody.java)."""
    a = np.ascontiguousarray(arr, np.float32)
    return {"ndarray": base64.b64encode(a.tobytes()).decode("ascii"),
            "shape": list(a.shape)}


def base64_to_ndarray(body: dict) -> np.ndarray:
    raw = base64.b64decode(body["ndarray"])
    return np.frombuffer(raw, np.float32).reshape(body["shape"])


class NearestNeighbor:
    """The search op (ref: server/NearestNeighbor.java — runs VPTree
    search and assembles index/distance results)."""

    def __init__(self, points: np.ndarray, distance: str = "euclidean"):
        self.points = np.asarray(points, np.float32)
        self.tree = VPTree(self.points, distance=distance)

    def search_index(self, idx: int, k: int) -> List[dict]:
        return self.search(self.points[idx], k + 1, skip_index=idx)[:k]

    def search(self, query: np.ndarray, k: int,
               skip_index: Optional[int] = None) -> List[dict]:
        idxs, dists = self.tree.knn(query, k)
        out = []
        for i, d in zip(idxs, dists):
            if skip_index is not None and i == skip_index:
                continue
            out.append({"index": int(i), "distance": float(d)})
        return out


class NearestNeighborsServer:
    """(ref: server/NearestNeighborsServer.java) — endpoints:

    POST /knn     {"ndarrayIndex": i, "k": n}
    POST /knnnew  {"k": n, "ndarray": ..., "shape": [...]}  (base64 body)

    both → {"results": [{"index": i, "distance": d}, ...]}
    """

    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 host: str = "127.0.0.1", port: int = 0):
        self.op = NearestNeighbor(points, distance)
        op = self.op

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, obj: dict) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    k = int(body.get("k", 1))
                    if self.path == "/knn":
                        idx = int(body["ndarrayIndex"])
                        results = op.search_index(idx, k)
                    elif self.path == "/knnnew":
                        q = base64_to_ndarray(body).reshape(-1)
                        results = op.search(q, k)
                    else:
                        self._json(404, {"error": f"no route {self.path}"})
                        return
                    self._json(200, {"results": results})
                except Exception as e:  # bad request payloads → 400
                    self._json(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

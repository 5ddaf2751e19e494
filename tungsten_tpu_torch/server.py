"""HTTP render server — the analog of tungsten-server
(src/tungsten-server/tungsten-server.cpp: civetweb endpoints for status
JSON, live framebuffer PNG, and the log).

Endpoints (default port 8080):
    /status        JSON {scene, spp_done, spp_total, elapsed_s, ksamples_s}
    /framebuffer   current film as PNG (tonemapped)
    /log           plain-text render log

Run standalone:  python -m tungsten_tpu_torch.server scene.json --spp 64 --port 8080
or embed: srv = RenderServer(port); srv.update(film, spp_done, ...);
the render driver (`render.py --serve PORT`) wires this automatically.

A copy of tungsten_tpu/server.py over the port's io/image.py.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class RenderServer:
    def __init__(self, port=8080, host="127.0.0.1"):
        self._lock = threading.Lock()
        self._film = None
        self._status = {"state": "idle", "spp_done": 0, "spp_total": 0,
                        "scene": "", "elapsed_s": 0.0, "ksamples_s": 0.0}
        self._log: list[str] = []
        self._t0 = time.time()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/status"):
                    with srv._lock:
                        body = json.dumps(srv._status).encode()
                    self._send(200, "application/json", body)
                elif self.path.startswith("/framebuffer"):
                    png = srv._film_png()
                    if png is None:
                        self._send(404, "text/plain", b"no framebuffer yet")
                    else:
                        self._send(200, "image/png", png)
                elif self.path.startswith("/log"):
                    with srv._lock:
                        body = "\n".join(srv._log).encode()
                    self._send(200, "text/plain", body)
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _film_png(self):
        with self._lock:
            film = self._film
        if film is None:
            return None
        from .io.image import write_png
        import tempfile, os
        # write_png writes to a path; route through a temp file
        fd, p = tempfile.mkstemp(suffix=".png")
        os.close(fd)
        try:
            write_png(p, film)
            with open(p, "rb") as f:
                return f.read()
        finally:
            os.unlink(p)

    def update(self, film=None, **status):
        with self._lock:
            if film is not None:
                self._film = np.asarray(film)
            self._status.update(status,
                                elapsed_s=round(time.time() - self._t0, 2))

    def log(self, msg):
        with self._lock:
            self._log.append(f"[{time.strftime('%H:%M:%S')}] {msg}")

    def shutdown(self):
        self._httpd.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)

    from .render import main as render_main
    render_main([args.scene, "--spp", str(args.spp),
                 "--serve", str(args.port)])


if __name__ == "__main__":
    main()

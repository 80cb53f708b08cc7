"""Tiny threaded HTTP progressive viewer (display-server-free).

Serves an auto-refreshing page with the latest render; the driver calls
``update(image_u8)`` after every sample pass — the role of the reference's
per-pixel mpsc channel + SFML loop (ref: src/renderer/viewer.rs:39-101,
fed at src/renderer/mod.rs:133-141 with the tonemapped running average).

Interactivity (the analog of viewer.rs:61-81's window-event handling):

- ``/status`` — JSON progress (samples done/total, elapsed, Mray/s),
  polled by the page's status line.
- ``/stop`` (the page's Stop button) — requests an early end: the render
  driver checks ``stop_requested`` between sample passes, stops cleanly,
  and finalizes the image over the samples actually accumulated (the
  HTTP analog of closing the reference's window).
- ``wait_for_close()`` — after the render, keeps serving the final frame
  until /stop or Ctrl-C (the analog of Viewer::wait_for_close).
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np

# Page interactivity mirrors the reference's SFML window (viewer.rs:61-81):
# mouse-wheel zoom anchored at the cursor (the view.zoom + set_center pair),
# drag to pan, double-click to reset the view, live status + Stop.
_PAGE = b"""<!doctype html><html><head><title>path-tracer-tpu</title></head>
<body style="margin:0;background:#111;color:#ccc;font:13px monospace;\
overflow:hidden">
<div style="padding:4px;position:relative;z-index:2">
  <span id="st">starting...</span>
  <button onclick="fetch('/stop',{method:'POST'})">Stop</button>
  <span style="opacity:.6">&nbsp;wheel: zoom &middot; drag: pan &middot;
  double-click: reset</span>
</div>
<div id="vp" style="position:fixed;inset:0;cursor:grab">
  <img id="im" draggable="false" style="image-rendering:pixelated;\
position:absolute;left:50%;top:50%;transform-origin:0 0;\
user-select:none"/>
</div>
<script>
const im = document.getElementById('im');
const vp = document.getElementById('vp');
const st = document.getElementById('st');
let z = 1, tx = 0, ty = 0;  // zoom + pan offset (view center analog)
function apply() {
  im.style.transform =
    `translate(-50%,-50%) translate(${tx}px,${ty}px) scale(${z})`;
}
vp.addEventListener('wheel', e => {
  e.preventDefault();
  const f = Math.pow(1.1, -Math.sign(e.deltaY));   // viewer.rs:71 analog
  const cx = e.clientX - vp.clientWidth / 2 - tx;
  const cy = e.clientY - vp.clientHeight / 2 - ty;
  tx -= cx * (f - 1); ty -= cy * (f - 1);          // anchor at the cursor
  z *= f; apply();
}, {passive: false});
let drag = null;
vp.addEventListener('mousedown', e => {
  e.preventDefault();  // defeat native <img> drag so panning works
  drag = [e.clientX, e.clientY];
});
window.addEventListener('mousemove', e => {
  if (!drag) return;
  tx += e.clientX - drag[0]; ty += e.clientY - drag[1];
  drag = [e.clientX, e.clientY]; apply();
});
window.addEventListener('mouseup', () => { drag = null; });
vp.addEventListener('dblclick', () => { z = 1; tx = ty = 0; apply(); });
apply();
setInterval(() => {
  const n = new Image();
  n.onload = () => { im.src = n.src; };   // swap only once loaded
  n.src = '/frame.png?' + Date.now();
}, 250);
setInterval(async () => {
  try {
    const s = await (await fetch('/status')).json();
    st.textContent = `${s.samples_done}/${s.samples_total} spp  ` +
      `${s.elapsed_s.toFixed(1)}s  ${s.mrays_per_s.toFixed(2)} Mray/s` +
      (s.done ? '  [done]' : s.stopping ? '  [stopping]' : '');
  } catch (e) {}
}, 500);
</script></body></html>"""


class ProgressiveViewer:
    def __init__(self, resolution, port: int = 8642):
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._server = None
        self._stop = threading.Event()
        self._status = {"samples_done": 0, "samples_total": 0,
                        "elapsed_s": 0.0, "mrays_per_s": 0.0,
                        "done": False, "stopping": False}
        self._t0 = time.time()
        self.url = None
        try:
            self._start_server(port)
        except OSError as e:
            import warnings

            warnings.warn(
                f"viewer could not bind port {port} ({e}); falling back to "
                "writing preview.png per pass", stacklevel=2)
            self._server = None

    def _start_server(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        body = viewer._png
                    self.send_response(200 if body else 404)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/status"):
                    with viewer._lock:
                        body = json.dumps(viewer._status).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/stop"):
                    viewer.request_stop()
                    self.send_response(200)
                    self.end_headers()
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def do_POST(self):  # noqa: N802
                if self.path.startswith("/stop"):
                    viewer.request_stop()
                    self.send_response(200)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # silence request logging
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/"
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        print(f"Viewer: {self.url}")

    # -- render-driver interface --------------------------------------------

    @property
    def stop_requested(self) -> bool:
        """True once the user asked to end the render early (checked by
        the render loop between sample passes)."""
        return self._stop.is_set()

    def request_stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._status["stopping"] = True

    def update(self, image_u8: np.ndarray, samples_done: int = 0,
               samples_total: int = 0, rays_done: int = 0) -> None:
        """Push the latest tonemapped frame ([H,W,3] uint8) + progress."""
        from path_tracer_tpu.utils.image_io import encode_png

        png = encode_png(np.asarray(image_u8, np.uint8))
        elapsed = time.time() - self._t0
        if self._server is not None:
            with self._lock:
                self._png = png
                self._status.update(
                    samples_done=int(samples_done),
                    samples_total=int(samples_total),
                    elapsed_s=elapsed,
                    mrays_per_s=(rays_done / max(elapsed, 1e-9)) / 1e6,
                    done=samples_done >= samples_total > 0
                    and not self._stop.is_set(),
                )
        else:
            with open("preview.png", "wb") as f:
                f.write(png)

    def wait_for_close(self) -> None:
        """Keep serving the final frame until /stop or Ctrl-C — the analog
        of the reference's Viewer::wait_for_close (viewer.rs:83-101)."""
        if self._server is None:
            return
        with self._lock:
            self._status["done"] = True
        print("Viewer still serving — press Ctrl-C or hit Stop to exit.")
        try:
            while not self._stop.wait(timeout=0.25):
                pass
        except KeyboardInterrupt:
            pass

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None

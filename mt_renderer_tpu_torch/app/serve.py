"""Frame-streaming frontend — the live-window analog for a headless host.

The reference presents frames through a winit window + wgpu swapchain and
pumps OS input events into the camera
(``src/renderer_app_manager.rs:202-272``). A headless host has no
display, so the closest honest equivalent is a tiny HTTP server: the
browser shows a multipart-replace image stream (motion PNG — stdlib-only;
no JPEG encoder) and posts key/mouse events back, which route through
``RendererAppManager.dispatch_event`` exactly like the scripted
``--events`` path.

Threading: HTTP handlers run on daemon threads; the RENDER LOOP OWNS THE
CALLING THREAD and is the only thread that touches the device. Handlers
only read the latest encoded PNG under a condition variable and append
events to a queue the render loop drains at frame start.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>mt_renderer_tpu_torch</title><style>
  body { margin: 0; background: #111; color: #ccc;
         font: 13px monospace; text-align: center; }
  img  { margin-top: 8px; image-rendering: pixelated; outline: none; }
  #hud { padding: 6px; }
</style></head><body>
<div id="hud">click the frame to fly &mdash; WASD + mouse, Esc releases</div>
<img id="v" src="/stream" tabindex="0">
<script>
const img = document.getElementById('v');
let queue = [];
function post() {
  if (!queue.length) return;
  const body = JSON.stringify(queue); queue = [];
  fetch('/event', {method: 'POST', body});
}
setInterval(post, 33);
img.addEventListener('click', () => img.requestPointerLock());
document.addEventListener('mousemove', (e) => {
  if (document.pointerLockElement === img)
    queue.push(['mouse', e.movementX, e.movementY]);
});
const keys = {w:'W', a:'A', s:'S', d:'D'};
document.addEventListener('keydown', (e) => {
  const k = keys[e.key.toLowerCase()];
  if (k && !e.repeat) queue.push(['key_down', k]);
});
document.addEventListener('keyup', (e) => {
  const k = keys[e.key.toLowerCase()];
  if (k) queue.push(['key_up', k]);
});
</script></body></html>
"""


class FrameStreamServer:
    """Publish frames from a ``RendererAppManager`` over HTTP.

    Routes: ``/`` viewer page, ``/stream`` multipart-replace PNG stream,
    ``/frame.png`` latest frame one-shot, ``/stats`` JSON,
    ``POST /event`` JSON list of input events
    (``[["mouse",dx,dy], ["key_down","W"], ...]``).
    """

    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 png_level: int = 1):
        self.manager = manager
        self.png_level = png_level
        self._cond = threading.Condition()
        self._png: bytes | None = None
        self._seq = 0
        self._events: list = []
        self._events_lock = threading.Lock()
        self._stop = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    # -- render-loop side --------------------------------------------------

    def serve(self, max_frames: int | None = None,
              fps_cap: float = 30.0) -> None:
        """Run setup + the render loop on the CALLING thread (the only
        thread that touches the device), publishing every frame. Returns
        after ``max_frames`` (None = until ``stop()``/KeyboardInterrupt)."""
        from .manager import _to_rgba

        self._thread.start()
        mgr = self.manager
        mgr.app.setup(mgr)
        min_dt = 1.0 / fps_cap if fps_cap else 0.0
        n = 0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                for ev in self.drain_events():
                    mgr.dispatch_event(ev)
                self.publish(_to_rgba(mgr.run_frame()))
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
                dt = time.perf_counter() - t0
                if dt < min_dt:
                    time.sleep(min_dt - dt)
        except KeyboardInterrupt:
            pass
        finally:
            mgr._flush_overflow()
            self.close()

    def publish(self, frame: np.ndarray) -> None:
        """Encode + hand the frame to waiting stream connections."""
        from ..utils.png import encode_png

        data = encode_png(frame, level=self.png_level)
        with self._cond:
            self._png = data
            self._seq += 1
            self._cond.notify_all()

    def drain_events(self) -> list:
        with self._events_lock:
            evs, self._events = self._events, []
        return evs

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        self.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- HTTP side ---------------------------------------------------------

    def _wait_frame(self, after_seq: int, timeout: float = 10.0):
        with self._cond:
            self._cond.wait_for(
                lambda: self._seq > after_seq or self._stop.is_set(),
                timeout=timeout)
            return self._png, self._seq

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # quiet; stats has the numbers
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/frame.png":
                    png, _ = server._wait_frame(0)
                    if png is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif self.path == "/stats":
                    mgr = server.manager
                    self._send(200, "application/json", json.dumps({
                        "frames": mgr.frame_index,
                        "frame_time_ms": round(mgr.frame_time * 1e3, 3),
                        "width": mgr.width, "height": mgr.height,
                    }).encode())
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=mtrframe")
                    # unbounded body: close delimits it under HTTP/1.1
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.end_headers()
                    seq = 0
                    while not server._stop.is_set():
                        png, seq = server._wait_frame(seq)
                        if png is None:
                            continue
                        try:
                            self.wfile.write(
                                b"--mtrframe\r\n"
                                b"Content-Type: image/png\r\n"
                                b"Content-Length: "
                                + str(len(png)).encode()
                                + b"\r\n\r\n" + png + b"\r\n")
                        except (BrokenPipeError, ConnectionResetError,
                                socket.timeout):
                            break
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/event":
                    self._send(404, "text/plain", b"not found")
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    evs = json.loads(self.rfile.read(length) or b"[]")
                    parsed = [tuple(ev) for ev in evs]
                except (ValueError, TypeError):
                    self._send(400, "text/plain", b"bad event json")
                    return
                with server._events_lock:
                    server._events.extend(parsed)
                self._send(200, "application/json",
                           b'{"queued": %d}' % len(parsed))

        return Handler

"""MJPEG-over-HTTP live preview for headless interactive sessions.

The port of ``bhr_tpu/utils/preview_server.py`` (host code, copied). GPU
hosts rarely have a display; the reference's zero-copy `ti.GUI` path
(render.py:4333) has no headless analogue. This serves the live render
as a multipart MJPEG stream any browser can show:

    http://host:PORT/         the live stream
    http://host:PORT/frame    one JPEG snapshot
    http://host:PORT/key?k=d  inject a key press (same bindings as the
                              matplotlib window: d/b/l, up/down, +/-,
                              0-8 solo, q quits the session)

Pure stdlib (http.server in a daemon thread) + PIL for JPEG encoding.
Latest-frame-wins: the renderer never blocks on slow viewers, and a
viewer joining late sees the current frame immediately.
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_BOUNDARY = "bhrframe"


def _encode_jpeg(frame: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    if frame.dtype != np.uint8:
        frame = np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class MJPEGServer:
    """Threaded MJPEG preview server.

    Usage:
        server = MJPEGServer(port=8089, on_key=session.handle_key)
        server.start()
        ... per frame: server.submit(rgb_frame)   # (H, W, 3) u8 or float
        server.stop()
    """

    def __init__(self, port: int = 8089,
                 on_key: Optional[Callable[[str], None]] = None,
                 quality: int = 85, host: str = "127.0.0.1"):
        # Loopback by default: /key is unauthenticated (it can inject
        # 'q' and end the session), so remote exposure must be an
        # explicit opt-in (--preview_host 0.0.0.0 / an SSH tunnel).
        self.host = str(host)
        self._requested_port = int(port)
        self.on_key = on_key
        self.quality = int(quality)
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._cond = threading.Condition()
        self._key_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _dispatch_key(self, k: str) -> None:
        # Locked so set_key_handler can atomically swap the handler and
        # drain queued keys without losing a concurrent press.
        with self._key_lock:
            if self.on_key is not None:
                self.on_key(k)

    def set_key_handler(self, fn: Callable[[str], None],
                        backlog=None) -> None:
        """Atomically install the real key handler and replay any keys
        queued while it was absent (e.g. while the renderer was built)."""
        with self._key_lock:
            queued = list(backlog) if backlog is not None else []
            if backlog is not None:
                backlog.clear()
            self.on_key = fn
        for k in queued:
            fn(k)

    # -- producer side ------------------------------------------------------

    def submit(self, frame: np.ndarray) -> None:
        """Publish a frame (encodes to JPEG on the caller's thread)."""
        data = _encode_jpeg(frame, self.quality)
        with self._cond:
            self._jpeg = data
            self._seq += 1
            self._cond.notify_all()

    @property
    def port(self) -> int:
        """The bound port (differs from the request when it was 0)."""
        return self._httpd.server_address[1] if self._httpd else \
            self._requested_port

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet: per-request stderr lines would swamp the HUD print.
            def log_message(self, *args):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/key":
                    keys = parse_qs(url.query).get("k", [])
                    for k in keys:
                        # parse_qs decodes '+' as a space (form
                        # encoding); the zoom-in key must still work
                        # from a literal /key?k=+ URL.
                        server._dispatch_key("+" if k == " " else k)
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    self.wfile.write(b"ok\n")
                    return
                if url.path in ("/frame", "/frame.jpg"):
                    jpeg = server._snapshot()
                    if jpeg is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                    return
                if url.path != "/":
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
                )
                self.end_headers()
                last = -1
                try:
                    while True:
                        jpeg, last = server._wait_frame(last)
                        if jpeg is None:  # server stopping
                            return
                        self.wfile.write(
                            f"--{_BOUNDARY}\r\nContent-Type: image/jpeg"
                            f"\r\nContent-Length: {len(jpeg)}\r\n\r\n"
                            .encode()
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return  # viewer closed the tab

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def _snapshot(self) -> Optional[bytes]:
        with self._cond:
            return self._jpeg

    def _wait_frame(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists.

        Also blocks while NO frame exists yet (a viewer opening the
        stream while the renderer is built must wait for frame 1, not
        get an immediately-closed connection). On timeout with a frame
        available, re-sends the current one so proxies keep the stream
        warm. Returns (None, last_seq) only when the server is
        stopping."""
        with self._cond:
            while self._httpd is not None and (
                self._jpeg is None or self._seq == last_seq
            ):
                if not self._cond.wait(timeout) and self._jpeg is not None:
                    break  # timeout: re-send the current frame
            if self._httpd is None:
                return None, last_seq
            return self._jpeg, self._seq

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        with self._cond:
            self._cond.notify_all()  # release stream handlers
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

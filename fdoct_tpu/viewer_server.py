"""Live viewer over a socket: HTTP streaming of the session windows.

The reference's display layer is six OpenCV HighGUI windows plus a
blocking ``waitKey`` keyboard dispatch (BscanFFT.cpp:486-538, 1584-1917).
On a headless accelerator host there is no X11; this module serves the same
windows over HTTP so any browser (or curl) on the operator's machine is
the display, and key presses flow back over the same socket:

- ``GET /``                 — HTML dashboard: live <img> per window, key
                              events forwarded via ``fetch POST /key``.
- ``GET /stream/<name>``    — ``multipart/x-mixed-replace`` PNG stream of
                              one window (push: a part is sent whenever
                              the session publishes a new frame).
- ``GET /frame/<name>.png`` — latest frame, single shot (for curl/tests).
- ``POST /key``             — body characters are queued; the session
                              loop drains them with :meth:`pop_keys`,
                              exactly where the reference polls waitKey.
- ``POST /roi``             — JSON ``{"x":…,"y":…,"w":…,"h":…}`` rectangle
                              in window pixel coordinates, queued for
                              :meth:`pop_rois`; the dashboard sends one per
                              mouse drag on the B-scan — the reference's
                              onMouse ROI selection
                              (BscanFFTpeak.cpp:112-181) over the socket.
- ``GET /config``           — current session knobs as JSON (live-editable
                              set + restart-required config), the
                              editiniadv GUI analog
                              (reference build/editiniadv.m:47-80).
- ``POST /config``          — JSON ``{field: value, ...}`` queued for
                              :meth:`pop_config`; the session applies
                              live-safe fields (threshold, averaging,
                              exposure/gain, clamp) at the next loop
                              boundary and reports restart-required ones.
- ``GET /status.json``      — window list + frame counters.

Pure stdlib (http.server, threading) + PIL for PNG encoding; no external
services.  The server runs in daemon threads; ``update()`` from the
session loop is non-blocking (encode + swap under a lock).
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_INDEX_HTML = """<!doctype html>
<html><head><title>fdoct live</title><style>
 body { background:#111; color:#ddd; font-family: monospace; }
 .w { display:inline-block; margin:6px; vertical-align:top; }
 .w div { padding:2px 0; color:#8bc; }
 img { image-rendering: pixelated; border:1px solid #333; }
 #help { color:#777; }
 #cfg { margin:8px 6px; color:#9a9; }
 #cfg table { border-collapse: collapse; }
 #cfg td { padding:1px 8px 1px 0; }
 #cfg input { background:#222; color:#ddd; border:1px solid #444;
              width:9em; font-family:monospace; }
 #cfg .ro input { color:#777; }
 #cfgmsg { color:#cc7; }
 summary { cursor:pointer; color:#8bc; }
</style></head><body>
<div id="help">keys are sent to the session (s=save, b=background,
p=pi/J0 frame, +/- exposure, ]/[ threshold, x=quit ...); drag on a
window to select an ROI</div>
<div id="windows"></div>
<details id="cfg"><summary>config (live knobs apply on Enter; greyed
fields need a restart)</summary>
<table id="cfgtable"></table><div id="cfgmsg"></div></details>
<script>
fetch('/status.json').then(r => r.json()).then(st => {
  const box = document.getElementById('windows');
  for (const name of st.windows) {
    const d = document.createElement('div'); d.className = 'w';
    d.style.position = 'relative';
    const img = document.createElement('img');
    img.src = '/stream/' + name;
    img.draggable = false;
    const label = document.createElement('div');
    label.textContent = name;
    d.appendChild(label); d.appendChild(img);
    box.appendChild(d);
    attachRoi(img, name);
  }
});
// config panel (the editiniadv GUI analog): live fields POST /config
function loadCfg() {
  fetch('/config').then(r => r.json()).then(c => {
    const t = document.getElementById('cfgtable');
    t.innerHTML = '';
    const add = (name, value, live) => {
      const tr = document.createElement('tr');
      if (!live) tr.className = 'ro';
      const td1 = document.createElement('td'); td1.textContent = name;
      const td2 = document.createElement('td');
      const inp = document.createElement('input');
      inp.value = value; inp.readOnly = !live;
      if (live) inp.addEventListener('keydown', ev => {
        if (ev.key !== 'Enter') return;
        ev.stopPropagation();
        const body = {}; body[name] = inp.value;
        fetch('/config', {method:'POST', body: JSON.stringify(body)})
          .then(() => setTimeout(loadCfg, 300));
        document.getElementById('cfgmsg').textContent =
          name + ' = ' + inp.value + ' sent';
      });
      inp.addEventListener('keydown', ev => ev.stopPropagation());
      td2.appendChild(inp); tr.appendChild(td1); tr.appendChild(td2);
      t.appendChild(tr);
    };
    for (const [k, v] of Object.entries(c.live || {})) add(k, v, true);
    for (const [k, v] of Object.entries(c.static || {})) add(k, v, false);
  });
}
document.getElementById('cfg').addEventListener('toggle', loadCfg);
// drag-rect ROI selection (the reference's onMouse drag,
// BscanFFTpeak.cpp:112-181): rectangle is reported in IMAGE pixels
function attachRoi(img, name) {
  let start = null, box = null;
  const toImg = ev => {
    const r = img.getBoundingClientRect();
    const sx = (img.naturalWidth || r.width) / r.width;
    const sy = (img.naturalHeight || r.height) / r.height;
    return [Math.round((ev.clientX - r.left) * sx),
            Math.round((ev.clientY - r.top) * sy)];
  };
  img.addEventListener('mousedown', ev => {
    start = toImg(ev);
    box = document.createElement('div');
    box.style.cssText = 'position:absolute;border:1px solid #fc0;' +
                        'pointer-events:none;';
    img.parentElement.appendChild(box);
    ev.preventDefault();
  });
  img.addEventListener('mousemove', ev => {
    if (!start || !box) return;
    const r = img.getBoundingClientRect(), p = img.parentElement.getBoundingClientRect();
    const [x, y] = toImg(ev);
    const sx = r.width / (img.naturalWidth || r.width);
    const sy = r.height / (img.naturalHeight || r.height);
    box.style.left = (r.left - p.left + Math.min(start[0], x) * sx) + 'px';
    box.style.top = (r.top - p.top + Math.min(start[1], y) * sy) + 'px';
    box.style.width = Math.abs(x - start[0]) * sx + 'px';
    box.style.height = Math.abs(y - start[1]) * sy + 'px';
  });
  img.addEventListener('mouseup', ev => {
    if (!start) return;
    const [x, y] = toImg(ev);
    const roi = {window: name,
                 x: Math.min(start[0], x), y: Math.min(start[1], y),
                 w: Math.abs(x - start[0]), h: Math.abs(y - start[1])};
    if (roi.w > 0 && roi.h > 0)
      fetch('/roi', {method: 'POST', body: JSON.stringify(roi)});
    start = null;
    if (box) { box.remove(); box = null; }
  });
}
document.addEventListener('keydown', ev => {
  if (ev.key.length === 1)
    fetch('/key', {method: 'POST', body: ev.key});
  else if (ev.key === 'Escape')
    fetch('/key', {method: 'POST', body: '\\x1b'});
});
</script></body></html>"""


def _encode_png(img: np.ndarray) -> bytes:
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    mode = "RGB" if arr.ndim == 3 else "L"
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


class ViewerServer:
    """Publish window images over HTTP; collect key presses.

    Thread-safe: ``update`` may be called from the session loop while
    handler threads stream.  ``port=0`` binds an ephemeral port (read it
    back from ``.port``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8089,
                 max_fps: float = 30.0):
        self._min_period = 1.0 / max_fps if max_fps > 0 else 0.0
        self._last: dict[str, float] = {}
        self._frames: dict[str, bytes] = {}
        self._seq: dict[str, int] = {}
        self._cond = threading.Condition()
        self._keys: list[str] = []
        self._rois: list[dict] = []
        self._config_updates: list[dict] = []
        self._klock = threading.Lock()
        # set by the session owner: () -> dict served on GET /config
        self.config_provider = None

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _INDEX_HTML.encode())
                elif self.path == "/status.json":
                    with server._cond:
                        st = {"windows": sorted(server._frames),
                              "frames": dict(server._seq)}
                    self._send(200, "application/json",
                               json.dumps(st).encode())
                elif self.path == "/config":
                    provider = server.config_provider
                    cfgst = provider() if provider is not None else {}
                    self._send(200, "application/json",
                               json.dumps(cfgst).encode())
                elif self.path.startswith("/frame/"):
                    name = self.path[len("/frame/"):].removesuffix(".png")
                    with server._cond:
                        data = server._frames.get(name)
                    if data is None:
                        self._send(404, "text/plain", b"no such window\n")
                    else:
                        self._send(200, "image/png", data)
                elif self.path.startswith("/stream/"):
                    self._stream(self.path[len("/stream/"):])
                else:
                    self._send(404, "text/plain", b"not found\n")

            def _stream(self, name: str) -> None:
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                try:
                    while not server._closed:
                        with server._cond:
                            server._cond.wait_for(
                                lambda: server._closed
                                or server._seq.get(name, -1) != seen,
                                timeout=1.0)
                            data = server._frames.get(name)
                            seen = server._seq.get(name, -1)
                        if data is None:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            b"Content-Length: %d\r\n\r\n" % len(data))
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):  # noqa: N802
                if self.path == "/key":
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n).decode(errors="replace")
                    with server._klock:
                        server._keys.extend(body)
                    self._send(200, "text/plain", b"ok\n")
                elif self.path == "/roi":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        roi = json.loads(self.rfile.read(n))
                        rect = {k: int(roi[k]) for k in ("x", "y", "w", "h")}
                        rect["window"] = str(roi.get("window", "bscan"))
                    except (ValueError, KeyError, TypeError):
                        self._send(400, "text/plain", b"bad roi\n")
                        return
                    with server._klock:
                        server._rois.append(rect)
                    self._send(200, "text/plain", b"ok\n")
                elif self.path == "/config":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        upd = json.loads(self.rfile.read(n))
                        if not isinstance(upd, dict) or not upd:
                            raise ValueError("not a non-empty object")
                    except ValueError:
                        self._send(400, "text/plain", b"bad config\n")
                        return
                    with server._klock:
                        server._config_updates.append(upd)
                    self._send(200, "text/plain", b"queued\n")
                else:
                    self._send(404, "text/plain", b"not found\n")

        self._closed = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def update(self, name: str, img: np.ndarray) -> None:
        """Publish a new frame for ``name`` (encodes PNG, wakes streams).

        Rate-limited per window (``max_fps``): the session loop can run far
        faster than any display needs, and the PNG encode is synchronous —
        excess updates are dropped, not queued."""
        now = time.monotonic()
        if self._min_period and now - self._last.get(name, 0.0) < self._min_period:
            return
        self._last[name] = now
        data = _encode_png(img)
        with self._cond:
            self._frames[name] = data
            self._seq[name] = self._seq.get(name, 0) + 1
            self._cond.notify_all()

    def pop_keys(self) -> str:
        """Drain queued browser key presses (the waitKey replacement)."""
        with self._klock:
            keys, self._keys = self._keys, []
        return "".join(keys)

    def pop_rois(self) -> list[dict]:
        """Drain queued drag-rectangle ROI selections (the onMouse
        replacement, BscanFFTpeak.cpp:112-181)."""
        with self._klock:
            rois, self._rois = self._rois, []
        return rois

    def pop_config(self) -> list[dict]:
        """Drain queued POST /config updates (the editiniadv GUI edit
        replacement); the session applies them via apply_config()."""
        with self._klock:
            upd, self._config_updates = self._config_updates, []
        return upd

    def close(self) -> None:
        self._closed = True
        with self._cond:
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

"""Live waterfall HTTP server (port of ``srtb_tpu/gui/server.py``).

The reference shows live Qt/QML waterfall windows, one per data stream
(ref: gui/gui.hpp:34-67, spectrum_image_provider.hpp, src/main.qml:14-28).
Headless, the :class:`~srtb_tpu_torch.gui.waterfall.WaterfallService`
writes PNG frames and this stdlib HTTP server serves an interactive live
view: per-stream panes that poll ``/frames.json`` and swap the image in
place, pause/resume, a history scrubber over the retained frames, zoom and
brightness/contrast.  The page, ``/frames.json`` and the frames are
byte-identical to the reference's for the same directory.

``/metrics`` (the Prometheus text exposition) and ``/metrics.json`` serve
the metrics registry (``utils/metrics.py``), each after the SLO tracker's
evaluation; ``/healthz`` serves ``utils/telemetry.health``: 200 while the
last segment is younger than ``health_stale_after_s`` (or before the
first), 503 once it is older, with the per-stream breakdown.  All three
answer as the reference's.  ``/fleet`` (the fleet's status, the
reference's ``obs/status.py``, ROADMAP A8c) answers 501 naming that item.
"""

from __future__ import annotations

import html
import http.server
import json
import os
import re
import threading

from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.utils import slo, telemetry, termination
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

_INDEX_TEMPLATE = """<!DOCTYPE html>
<html><head><title>srtb_tpu waterfall</title>
<style>
body{{background:#111;color:#eee;font-family:monospace;margin:12px}}
img{{image-rendering:pixelated;border:1px solid #444;display:block}}
.pane{{margin-bottom:14px}}
.bar{{margin:4px 0}}
button{{background:#222;color:#eee;border:1px solid #555;margin-right:4px}}
input[type=range]{{vertical-align:middle}}
#metrics{{color:#8c8;margin-bottom:10px}}
</style></head>
<body><h2>srtb_tpu spectrum waterfall</h2>
<div id="metrics">metrics: …</div>
<div id="panes">{body}</div>
<script>
"use strict";
const panes = {{}};   // stream -> {{paused, pos, frames, img, slider, label}}
// server-rendered pane markup with __S__ placeholders, so a stream that
// starts publishing only after page load still gets a pane (round-3
// advisor catch: tick() used to skip unknown streams forever)
const PANE_HTML = {pane_js};
function addPane(s) {{
  const host = document.createElement("div");
  host.innerHTML = PANE_HTML.replaceAll("__S__", s);
  // no frame name yet: drop the placeholder src (setFrame fills it on
  // the same tick) rather than fetching "/" into the <img>
  host.querySelector("img").removeAttribute("src");
  document.getElementById("panes").appendChild(host.firstElementChild);
  wire(s);
}}
function setFrame(s) {{
  const p = panes[s];
  if (!p.frames.length) return;
  const i = Math.min(p.pos, p.frames.length - 1);
  p.img.src = "/" + p.frames[i];
  p.label.textContent = p.frames[i] +
    (p.paused ? "  [paused]" : "  [live]");
  p.slider.max = p.frames.length - 1;
  p.slider.value = i;
}}
function wire(s) {{
  const el = document.getElementById("pane" + s);
  const p = panes[s] = {{
    paused: false, pos: 0, frames: [],
    img: el.querySelector("img"),
    slider: el.querySelector("input[type=range]"),
    label: el.querySelector(".fname"),
  }};
  el.querySelector(".pause").onclick = (e) => {{
    p.paused = !p.paused;
    e.target.textContent = p.paused ? "resume" : "pause";
    if (!p.paused) p.pos = Math.max(0, p.frames.length - 1);
    setFrame(s);
  }};
  p.slider.oninput = () => {{
    p.paused = true;
    el.querySelector(".pause").textContent = "resume";
    p.pos = +p.slider.value;
    setFrame(s);
  }};
  let zoom = 1;
  el.querySelector(".zin").onclick = () => {{
    zoom = Math.min(8, zoom * 2); p.img.style.width =
      (p.img.naturalWidth * zoom) + "px";
  }};
  el.querySelector(".zout").onclick = () => {{
    zoom = Math.max(0.25, zoom / 2); p.img.style.width =
      (p.img.naturalWidth * zoom) + "px";
  }};
  const bright = el.querySelector(".bright"),
        contrast = el.querySelector(".contrast");
  const filt = () => {{
    p.img.style.filter =
      `brightness(${{bright.value}}%) contrast(${{contrast.value}}%)`;
  }};
  bright.oninput = filt; contrast.oninput = filt;
}}
async function tick() {{
  try {{
    const r = await fetch("/frames.json");
    const data = await r.json();
    for (const s in data.streams) {{
      if (!(s in panes)) addPane(s);
      const p = panes[s];
      p.frames = data.streams[s];
      if (!p.paused) p.pos = Math.max(0, p.frames.length - 1);
      setFrame(s);
    }}
  }} catch (e) {{}}
  try {{
    const m = await (await fetch("/metrics.json")).json();
    const keys = ["segments", "samples", "segments_dropped",
                  "udp_lost_packets", "elapsed_s"];
    document.getElementById("metrics").textContent = "metrics: " +
      keys.filter(k => k in m).map(k => `${{k}}=${{m[k]}}`).join("  ");
  }} catch (e) {{}}
}}
document.querySelectorAll(".pane").forEach(
  el => wire(+el.dataset.stream));
tick(); setInterval(tick, 1000);
</script>
</body></html>
"""

_PANE_TEMPLATE = """<div class="pane" id="pane{s}" data-stream="{s}">
<div>stream {s}: <span class="fname">{name}</span></div>
<div class="bar">
<button class="pause">pause</button>
<button class="zin">zoom+</button>
<button class="zout">zoom-</button>
history <input type="range" min="0" max="0" value="0">
bright <input class="bright" type="range" min="20" max="300"
 value="100">
contrast <input class="contrast" type="range" min="20" max="300"
 value="100">
</div>
<img src="/{name}"></div>
"""


# endpoints of later slices: path -> the ROADMAP item they wait for
UNPORTED_ENDPOINTS = {
    "/fleet": ("ROADMAP A8c: the fleet's status (obs/status.py over the "
               "fleet of pipeline/fleet.py)"),
}


class _Handler(http.server.BaseHTTPRequestHandler):
    directory = "."
    health_stale_after_s = 30.0

    def log_message(self, *args):  # quiet
        pass

    def _all_frames(self):
        """stream -> frame names sorted by index (the retained history
        the scrubber moves over)."""
        pat = re.compile(r"waterfall_s(\d+)_(\d+)\.png$")
        frames: dict[int, list[tuple[int, str]]] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for name in names:
            m = pat.match(name)
            if m:
                frames.setdefault(int(m.group(1)), []).append(
                    (int(m.group(2)), name))
        return {s: [name for _, name in sorted(v)]
                for s, v in frames.items()}

    def _latest_frames(self):
        return {s: v[-1] for s, v in self._all_frames().items() if v}

    def _send(self, code: int, ctype: str, data: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        try:
            self._do_get()
        except ConnectionError:
            # browsers abort in-flight <img> loads on every index refresh
            pass

    def _do_get(self):
        if self.path in ("/metrics", "/metrics.json"):
            # the SLO gauges refreshed right before the scrape (a no-op
            # when no objective is armed)
            slo.evaluate()
            if self.path == "/metrics.json":
                self._send(200, "application/json", (json.dumps(
                    metrics.snapshot(), sort_keys=True) + "\n").encode())
            else:
                self._send(200, "text/plain; version=0.0.4",
                           metrics.prometheus().encode())
            return
        if self.path == "/healthz":
            # last-segment-age staleness: 503 while no segment came for
            # health_stale_after_s, without help from a stuck thread
            h = telemetry.health(stale_after_s=self.health_stale_after_s)
            self._send(200 if h["ok"] else 503, "application/json",
                       (json.dumps(h, sort_keys=True) + "\n").encode())
            return
        if self.path in UNPORTED_ENDPOINTS:
            self._send(501, "text/plain", (
                f"{self.path} is not ported yet "
                f"({UNPORTED_ENDPOINTS[self.path]})\n").encode())
            return
        if self.path == "/frames.json":
            self._send(200, "application/json", (json.dumps(
                {"streams": self._all_frames()}) + "\n").encode())
            return
        if self.path in ("/", "/index.html"):
            frames = self._latest_frames()
            if frames:
                body = "".join(
                    _PANE_TEMPLATE.format(s=s, name=html.escape(name))
                    for s, name in sorted(frames.items()))
            else:
                body = ('<p>no frames yet (panes appear on first '
                        'refresh with data)</p>'
                        '<meta http-equiv="refresh" content="2">')
            pane_js = json.dumps(
                _PANE_TEMPLATE.format(s="__S__", name=""))
            self._send(200, "text/html", _INDEX_TEMPLATE.format(
                body=body, pane_js=pane_js).encode())
            return
        name = os.path.basename(self.path)
        path = os.path.join(self.directory, name)
        if name.endswith(".png") and os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            self._send(200, "image/png", data)
            return
        self.send_response(404)
        self.end_headers()


class WaterfallHTTPServer:
    """Serve the waterfall PNG directory on a background thread.

    The serve thread is supervised: if ``serve_forever`` dies, it is
    restarted within the supervisor's budget instead of leaving the
    observation without its live view.  The GUI is best-effort, so the
    default supervisor restarts whatever the error; an exhausted budget
    logs and gives up (it never takes the pipeline down).  ``stop()``
    joins the thread."""

    def __init__(self, directory: str, port: int = 0,
                 address: str = "127.0.0.1",
                 health_stale_after_s: float = 30.0, supervisor=None):
        handler = type("Handler", (_Handler,), {
            "directory": directory,
            "health_stale_after_s": float(health_stale_after_s)})
        self._httpd = http.server.ThreadingHTTPServer((address, port),
                                                      handler)
        self.port = self._httpd.server_address[1]
        if supervisor is None:
            supervisor = Supervisor("gui_server", max_restarts=3,
                                    restart_fatal=True)
        self._supervisor = supervisor
        self._stopping = False
        self._thread = threading.Thread(target=self._serve,
                                        name="srtb-gui-server",
                                        daemon=True)
        termination.tag_thread(self._thread)

    def _serve(self):
        while True:
            try:
                self._httpd.serve_forever()
                return  # shutdown() was called: clean exit
            except Exception as e:  # noqa: BLE001 - supervised restart
                if self._stopping or \
                        not self._supervisor.should_restart(e):
                    log.error(f"[gui] server thread giving up: {e!r}")
                    return

    def start(self) -> "WaterfallHTTPServer":
        self._thread.start()
        log.info(f"[gui] waterfall at http://127.0.0.1:{self.port}/")
        return self

    def stop(self):
        self._stopping = True
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

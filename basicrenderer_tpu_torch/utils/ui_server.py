"""Headless settings/telemetry UI: a tiny HTTP control surface for a live
Renderer.

Host-only copy of basicrenderer_tpu/utils/ui_server.py, serving the port's
Renderer (the reference's interactive ImGui menu, BasicRenderer/include/
Menu.h — settings widgets, frame telemetry plots, debug-view switching).
The renderer runs headless next to its device, so the "UI" is an embedded
HTTP endpoint on 127.0.0.1: a browser (or curl) on the same machine can
inspect and flip every registered setting, watch frame telemetry, and
pull rendered frames — including the debug views — while the host app
keeps driving the frame loop.

Endpoints
  GET  /                      minimal single-page dashboard (vanilla JS)
  GET  /api/settings          settings catalog {name: {value, structural,
                              description}} + structural generation
  POST /api/settings          {"name": value, ...} -> applies via
                              SettingsManager.set (structural changes
                              build a new frame function on next render)
  GET  /api/telemetry?n=60    last frame + n-frame averages + counters
  GET  /api/views             available debug views
  GET  /api/frame.png[?view=] render one frame (optionally in a debug view,
                              restoring the previous view after) as PNG

Everything is stdlib-only (http.server + utils/png.py's zlib PNG writer) —
no external UI dependency to gate on.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .png import encode_png

DEBUG_VIEWS = ("none", "normals", "depth", "albedo", "material", "clusters",
               "ao", "uv")


_DASHBOARD = """<!doctype html><html><head><meta charset="utf-8">
<title>basicrenderer_tpu_torch</title><style>
body{font:13px monospace;background:#151515;color:#ddd;margin:16px}
table{border-collapse:collapse}td{padding:2px 8px;border-bottom:1px solid #333}
input,select{background:#222;color:#ddd;border:1px solid #444;font:inherit}
h2{color:#8cf;font-size:14px}img{border:1px solid #444;max-width:640px}
.s{color:#fa6}.num{color:#9f9}</style></head><body>
<h2>basicrenderer_tpu_torch — live control</h2>
<div style="display:flex;gap:24px;flex-wrap:wrap">
<div><h2>frame</h2>
<select id="view"></select> <button onclick="refresh()">render</button><br>
<img id="frame"></div>
<div><h2>settings <span class="s">(orange = structural: a new frame)</span></h2>
<table id="settings"></table></div>
<div><h2>telemetry</h2><pre id="telemetry"></pre></div></div>
<script>
async function j(u,o){const r=await fetch(u,o);return r.json()}
async function loadViews(){const v=await j('/api/views');const s=document.getElementById('view');
 s.innerHTML=v.views.map(x=>`<option>${x}</option>`).join('')}
function refresh(){const v=document.getElementById('view').value;
 document.getElementById('frame').src='/api/frame.png?view='+v+'&t='+Date.now()}
async function loadSettings(){const d=await j('/api/settings');
 const rows=Object.entries(d.settings).map(([k,s])=>{
  const cls=s.structural?'s':'';let inp;
  if(typeof s.value=='boolean')inp=`<input type=checkbox ${s.value?'checked':''}
    onchange="setS('${k}',this.checked)">`;
  else inp=`<input value='${JSON.stringify(s.value)}'
    onchange="setS('${k}',JSON.parse(this.value))">`;
  return `<tr><td class="${cls}" title="${s.description||''}">${k}</td><td>${inp}</td></tr>`});
 document.getElementById('settings').innerHTML=rows.join('')}
async function setS(k,v){await j('/api/settings',{method:'POST',
 body:JSON.stringify({[k]:v})});loadSettings()}
async function loadTelemetry(){const d=await j('/api/telemetry');
 document.getElementById('telemetry').textContent=JSON.stringify(d,null,1)}
loadViews();loadSettings();loadTelemetry();setInterval(loadTelemetry,2000)
</script></body></html>"""


class UIServer:
    """Serve a live Renderer over HTTP. `port=0` picks a free port.

    The server renders on demand under `render_lock` — share the same lock
    from your frame loop if you drive the renderer concurrently.
    """

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 0):
        self.renderer = renderer
        self.render_lock = threading.Lock()
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj: Any, code: int = 200):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    q = parse_qs(u.query)
                    if u.path == "/":
                        self._send(200, _DASHBOARD.encode(), "text/html")
                    elif u.path == "/api/settings":
                        self._json(ui.settings_payload())
                    elif u.path == "/api/views":
                        self._json({"views": list(DEBUG_VIEWS)})
                    elif u.path == "/api/scene":
                        self._json(ui.scene_payload())
                    elif u.path == "/api/telemetry":
                        n = int(q.get("n", ["60"])[0])
                        self._json(ui.telemetry_payload(n))
                    elif u.path == "/api/frame.png":
                        view = q.get("view", [None])[0]
                        png = ui.render_png(view)
                        self._send(200, png, "image/png")
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # surface, don't kill the thread
                    self._json({"error": repr(e)}, 500)

            def do_POST(self):
                try:
                    u = urlparse(self.path)
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if u.path == "/api/settings":
                        for k, v in body.items():
                            if isinstance(v, list):
                                v = tuple(v)
                            ui.renderer.settings.set(k, v)
                        self._json(ui.settings_payload())
                    elif u.path == "/api/scene/transform":
                        self._json(ui.apply_transform(body))
                    elif u.path == "/api/input":
                        self._json(ui.push_input(body))
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:
                    self._json({"error": repr(e)}, 500)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- payloads ----------------------------------------------------------
    def scene_payload(self) -> Dict[str, Any]:
        """Scene-graph explorer: entities with transforms + renderables
        (reference: Menu.h scene tree, Menu.h:163-170)."""
        from ..scene.components import (Parent, Position, Renderable,
                                        Rotation, Scale)
        sc = self.renderer.scene
        if sc is None:
            return {"entities": []}
        w = sc.world
        ents = []
        for e, (pos,) in w.query(Position):
            row: Dict[str, Any] = {"entity": int(e),
                                   "position": [float(x) for x in pos.value]}
            names = [t[5:] for t, members in w._tags.items()
                     if t.startswith("name:") and e in members]
            if names:
                row["name"] = names[0]
            if w.has(e, Rotation):
                row["rotation"] = [float(x) for x in w.get(e, Rotation).value]
            if w.has(e, Scale):
                row["scale"] = [float(x) for x in w.get(e, Scale).value]
            if w.has(e, Parent):
                row["parent"] = int(w.get(e, Parent).entity)
            if w.has(e, Renderable):
                r = w.get(e, Renderable)
                row["mesh"] = int(r.mesh_id)
                row["material"] = int(r.material_id)
            ents.append(row)
        return {"entities": ents}

    def apply_transform(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Live scene edit over the deferred-edit protocol: the change
        queues on world.defer and lands at the next Renderer.update()
        flush (never mid-frame — reference: Menu transform editing
        through the scene-update phase, Menu.h:163-170)."""
        from ..scene.components import Position, Rotation, Scale
        import numpy as np
        sc = self.renderer.scene
        if sc is None:
            return {"error": "no scene"}
        eid = int(body["entity"])
        if not sc.world.is_alive(eid):
            return {"error": f"entity {eid} not alive"}
        sets = []
        for key, ctype, n in (("position", Position, 3),
                              ("rotation", Rotation, 4),
                              ("scale", Scale, 3)):
            if key in body:
                v = np.asarray(body[key], np.float32).reshape(n)
                sets.append((ctype, v))

        def apply():
            for ctype, v in sets:
                sc.world.set(eid, ctype(v))

        sc.world.defer(apply)
        return {"queued": {"entity": eid,
                           "fields": [k for k in ("position", "rotation",
                                                  "scale") if k in body]}}

    def push_input(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Enqueue raw input events (reference: the window message loop
        feeding InputContext::ProcessInput — headless here, so events
        arrive over HTTP: [{kind, key?, dx?, dy?, wheel?, buttons?}, ...]
        or a single event object). The embedding app owns the InputPump
        (renderer.input_pump when set) and calls pump(dt) per frame."""
        from .input import InputEvent
        pump = getattr(self.renderer, "input_pump", None)
        if pump is None:
            return {"error": "no input pump attached"}
        events = body if isinstance(body, list) else [body]
        for e in events:
            pump.push(InputEvent(
                kind=str(e.get("kind", "key_down")),
                key=str(e.get("key", "")),
                dx=float(e.get("dx", 0.0)), dy=float(e.get("dy", 0.0)),
                wheel=float(e.get("wheel", 0.0)),
                buttons=int(e.get("buttons", 0))))
        return {"queued": len(events)}

    def settings_payload(self) -> Dict[str, Any]:
        s = self.renderer.settings
        with s._lock:
            cat = {name: {"value": st.value, "structural": st.structural,
                          "description": st.description}
                   for name, st in s._settings.items()}
        return {"settings": cat, "generation": s.generation}

    def telemetry_payload(self, n: int = 60) -> Dict[str, Any]:
        t = self.renderer.telemetry

        def fetch(v):
            try:
                return int(v)
            except Exception:
                try:
                    return float(v)
                except Exception:
                    return str(v)

        last = t.last()
        if last is not None:
            last = {"frame": last.get("frame"),
                    "frame_ms": last.get("frame_ms"),
                    "stages": last.get("stages", {}),
                    "counters": {k: fetch(v)
                                 for k, v in last.get("counters", {}).items()}}
        return {"frame_index": t.frame_index, "last": last,
                "averages": t.averages(n)}

    def render_png(self, view: Optional[str] = None) -> bytes:
        r = self.renderer
        with self.render_lock:
            prev = r.settings.get("debugView")
            try:
                if view is not None and view != prev:
                    r.settings.set("debugView", view)
                r.update()
                img = r.render_to_numpy()
            finally:
                if view is not None and view != prev:
                    r.settings.set("debugView", prev)
        return encode_png(img)

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "UIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

"""Live frame-streaming viewer (port of rend3_tpu/framework/viewer.py) — the
windowed event loop of the reference
framework (rend3-framework/src/lib.rs:177-382: winit window + redraw loop +
input events), re-hosted for a machine with no display attached: frames
stream to a browser over localhost HTTP and key/mouse events stream back.

The render loop owns the renderer (single-threaded, like the reference's
event loop); an http.server thread serves
  /            — viewer page (canvas + WASD/mouse capture JS)
  /frame.png   — the latest rendered frame (client long-polls via fetch)
  /input       — key/mouse events as query params
Input is applied to `app.controls` (a framework.camera.FirstPersonControls)
when present, mirroring scene_viewer's Grabber+scancode handling
(examples/src/scene_viewer/mod.rs:516-577)."""

from __future__ import annotations

import io
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["serve_app"]

_PAGE = """<!doctype html>
<html><head><title>rend3-tpu viewer</title><style>
body{margin:0;background:#111;display:flex;flex-direction:column;align-items:center;color:#ccc;font:13px monospace}
img{image-rendering:pixelated;outline:none}
</style></head><body>
<p>click to grab &middot; WASD+Q move &middot; shift run &middot; drag = look &middot; esc release</p>
<img id=v tabindex=0 width=%W% height=%H%>
<script>
const v=document.getElementById('v');let grabbed=false,px=0,py=0;
function send(q){fetch('/input?'+q)}
v.onclick=()=>{grabbed=true;v.focus()};
let rt=null;window.addEventListener('resize',()=>{clearTimeout(rt);rt=setTimeout(()=>{
 const w=Math.max(128,Math.floor(window.innerWidth*0.95)),h=Math.max(128,Math.floor(window.innerHeight*0.9));
 v.width=w;v.height=h;send('w='+w+'&h='+h)},300)});
document.addEventListener('keydown',e=>{if(e.key==='Escape'){grabbed=false;return}
 if(grabbed){send('key='+encodeURIComponent(e.key.toLowerCase())+'&down=1');e.preventDefault()}});
document.addEventListener('keyup',e=>{if(grabbed)send('key='+encodeURIComponent(e.key.toLowerCase())+'&down=0')});
v.addEventListener('mousedown',e=>{px=e.clientX;py=e.clientY});
v.addEventListener('mousemove',e=>{if(grabbed&&e.buttons){send('dx='+(e.clientX-px)+'&dy='+(e.clientY-py));px=e.clientX;py=e.clientY}});
(async function loop(){for(;;){try{const r=await fetch('/frame.png?t='+Date.now());
 const b=await r.blob();v.src=URL.createObjectURL(b)}catch(e){await new Promise(s=>setTimeout(s,250))}}})();
</script></body></html>"""


def serve_app(app, width: int, height: int, port: int = 8080, device="cuda") -> None:
    """Run `app` under a live browser viewer; blocks until interrupted. The
    renderer runs on `device` (the card unless "cpu"); without a card it
    raises before the server binds its socket."""
    from . import FrameRenderTarget, RedrawContext, _setup

    renderer, base_graph, overlay, settings, target = _setup(app, width, height, device)

    latest = {"png": b"", "seq": 0}
    frame_ready = threading.Condition()
    controls = getattr(app, "controls", None)
    input_lock = threading.Lock()
    pending = {"resize": None}  # picked up by the render loop

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                body = _PAGE.replace("%W%", str(width)).replace("%H%", str(height)).encode()
                self._send(200, "text/html", body)
            elif url.path == "/frame.png":
                with frame_ready:
                    frame_ready.wait(timeout=5.0)
                    body = latest["png"]
                self._send(200, "image/png", body)
            elif url.path == "/input":
                q = urllib.parse.parse_qs(url.query)
                with input_lock:
                    if "w" in q and "h" in q:
                        # Surface resize (reference: rend3-framework
                        # lib.rs:393-433 reconfigures the surface and calls
                        # set_aspect_ratio).
                        pending["resize"] = (int(q["w"][0]), int(q["h"][0]))
                    if "key" in q:
                        key = q["key"][0]
                        down = q.get("down", ["1"])[0] == "1"
                        if key == "p" and down:
                            # Chrome-trace dump on 'P' (reference:
                            # scene_viewer/mod.rs:630-639).
                            from ..utils.profiling import dump_chrome_trace

                            dump_chrome_trace("trace.json")
                            print("viewer: wrote trace.json")
                        elif controls is not None:
                            controls.key(key, down)
                    if controls is not None and ("dx" in q or "dy" in q):
                        controls.mouse(float(q.get("dx", [0])[0]), float(q.get("dy", [0])[0]))
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://127.0.0.1:{port}/  (ctrl-c to stop)")

    last = time.perf_counter()
    elapsed = 0.0
    try:
        while True:
            now = time.perf_counter()
            dt, last = now - last, now
            with input_lock:
                resize = pending["resize"]
                pending["resize"] = None
                if controls is not None:
                    controls.update(dt)
            if resize is not None and resize != (width, height):
                # Reconfigure the target + aspect ratio (reference:
                # handle_surface + set_aspect_ratio, lib.rs:393-433).
                width, height = resize
                renderer.set_aspect_ratio(width / height)
                target = FrameRenderTarget(width, height, app.sample_count())
                print(f"viewer: resized to {width}x{height}")
            ctx = RedrawContext(
                renderer=renderer,
                base_graph=base_graph,
                resolution=(width, height),
                delta_t_seconds=dt,
                elapsed=elapsed,
                overlay=overlay,
            )
            app.handle_redraw(ctx)
            renderer.swap_instruction_buffers()
            eval_output = renderer.evaluate_instructions()
            img = base_graph.render_frame(
                eval_output, target, settings, skybox_slot=app.skybox_slot()
            )
            jobs = app.overlay_jobs(ctx)
            if jobs:
                img = overlay.render(img, jobs)
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(np.asarray(img)).save(buf, "PNG")
            with frame_ready:
                latest["png"] = buf.getvalue()
                latest["seq"] += 1
                frame_ready.notify_all()
            elapsed += dt
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()

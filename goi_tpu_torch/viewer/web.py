"""Minimal web viewer: an HTTP server and an embedded browser client.

Counterpart of goi_tpu/viewer/web.py. `WebViewer` serves a
self-contained HTML/JS orbit viewer at `/` and renders frames at
`/frame?...`: drag to orbit, wheel to zoom, an optional prompt box that
reaches the render callback (the GUI's text-entry path,
ref:gui/main.py:992-1003). The page revokes each frame's object URL
when the next one replaces it.

    viewer = WebViewer(render_fn, port=8090)    # cameras on the card
    viewer.start()            # daemon thread; open http://host:8090

render_fn(cam, prompt: str | None) -> (3, H, W) float image in [0, 1]
(an array or a tensor). Frames are encoded with PIL.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>goi_tpu_torch viewer</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif}
 #bar{padding:6px}#cv{display:block;cursor:grab}
 input{background:#222;color:#ddd;border:1px solid #555}
</style></head><body>
<div id=bar>goi_tpu_torch web viewer &nbsp;
 prompt: <input id=prompt size=28>
 <span id=stat></span></div>
<img id=cv width=640 height=480>
<script>
let az=0, el=15, r=3.5, busy=false, dirty=true, url=null;
const img=document.getElementById('cv');
const stat=document.getElementById('stat');
let drag=false, lx=0, ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 az-=0.4*(e.clientX-lx); el+=0.4*(e.clientY-ly);
 el=Math.max(-89,Math.min(89,el)); lx=e.clientX;ly=e.clientY;
 dirty=true;};
img.onwheel=e=>{e.preventDefault();r*=Math.pow(1.1,e.deltaY>0?1:-1);
 dirty=true;};
async function loop(){
 if(dirty&&!busy){busy=true;dirty=false;
  const p=encodeURIComponent(document.getElementById('prompt').value);
  const t0=performance.now();
  const u=`/frame?elev=${el}&azim=${az}&radius=${r}&w=640&h=480&prompt=${p}`;
  try{const b=await (await fetch(u)).blob();
   if(url)URL.revokeObjectURL(url);
   url=URL.createObjectURL(b);
   img.src=url;
   stat.textContent=` ${(performance.now()-t0).toFixed(0)} ms`;
  }catch(e){stat.textContent=' error';}
  busy=false;}
 requestAnimationFrame(loop);}
document.getElementById('prompt').onchange=()=>dirty=true;
loop();
</script></body></html>"""


def _as_u8_hwc(img_chw) -> np.ndarray:
    """(3|1, H, W) or (H, W, 3|1) image, float in [0, 1] or uint8, array
    or tensor -> (H, W, 3) uint8 (x 255, clipped, truncated)."""
    arr = img_chw.detach().cpu().numpy() if torch.is_tensor(img_chw) \
        else np.asarray(img_chw)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.dtype != np.uint8:   # frames quantized on the device are uint8
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def _encode(img_chw, fmt: str, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_as_u8_hwc(img_chw)).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _to_png(img_chw) -> bytes:
    """PNG at zlib level 1: lossless, and quicker to encode than PIL's
    default level 6 (on a 1296x960 frame, PERF.md)."""
    return _encode(img_chw, "PNG", compress_level=1)


def _to_jpeg(img_chw, quality: int = 90) -> bytes:
    """JPEG frames for the interactive viewer: far cheaper to encode
    than PNG at 1296x968."""
    return _encode(img_chw, "JPEG", quality=quality)


def orbit_view_camera(q: dict, fovy_deg: float, device):
    """The renderer's Camera of a viewer request's orbit parameters
    (elev, azim, radius, w, h, scale). scale < 1 renders a preview at
    reduced resolution, 16-pixel aligned (the reference GUI's
    interactive downscale, ref:utils/camera_utils.py:28-71); the
    browser upscales it."""
    from goi_tpu_torch.app.orbit_ngp import NGPOrbitCamera

    sc = float(q.get("scale", 1.0))
    w = max(16, int(round(int(q.get("w", 640)) * sc / 16)) * 16)
    h = max(16, int(round(int(q.get("h", 480)) * sc / 16)) * 16)
    cam = NGPOrbitCamera(w, h, r=float(q.get("radius", 3.5)), fovy=fovy_deg)
    cam.orbit_to(float(q.get("elev", 0.0)), float(q.get("azim", 0.0)))
    return cam.to_camera(device=device)


class WebViewer:
    def __init__(self, render_fn: Callable, host: str = "0.0.0.0",
                 port: int = 8090, fovy_deg: float = 50.0, device="cuda"):
        self.render_fn = render_fn
        self.fovy_deg = fovy_deg
        self.device = torch.device(device)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._reply(200, "text/html", _PAGE.encode("utf-8"))
                elif u.path == "/frame":
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    try:
                        self._reply(200, "image/png", outer._frame(q))
                    except Exception as e:  # surface errors to the page
                        self._reply(500, "application/json",
                                    json.dumps({"error": repr(e)}).encode())
                else:
                    self._reply(404, "text/plain", b"not found")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _frame(self, q: dict) -> bytes:
        cam = orbit_view_camera(q, self.fovy_deg, self.device)
        return _to_png(self.render_fn(cam, q.get("prompt") or None))

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"[goi_tpu_torch] web viewer at http://127.0.0.1:{self.port}")

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

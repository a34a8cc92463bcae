"""Interactive query app over HTTP: the web re-host of the reference's
DearPyGui main app (ref:gui/main.py:769-1496).

Counterpart of goi_tpu/viewer/app.py. `QueryWebApp` binds a
`QuerySession` and exposes each model-side GUI operation as an
endpoint, with a self-contained browser client at `/`:

  render modes     image / depth / alpha + similarity overlay toggle
                   (ref:gui/main.py:549-604 test_step)
  text query       prompt box -> text_fn -> session.set_text
                   (ref:gui/main.py:992-1003)
  3D retrieval     retrieve / segment / delete-view / delete-perm /
                   move / reset (ref:gui/main.py:1168-1240,1418-1496)
  OSH finetune     RES mask from res_fn (or a client-supplied mask) ->
                   session.finetune_with_res (ref:gui/main.py:1673-1763)
  grouping         DBSCAN group_points (ref:gui/main.py:1595-1671)
  video            anchor-pose slerp path -> mp4 (ref:gui/main.py:
                   1766-1821)

The SDS edit operations (edit_precompute, edit_train) answer "no edit
session configured": the edit session is not ported. Frames render on
the session's device, and the page revokes each frame's object URL when
the next one replaces it.

Hooks (both optional):
  text_fn(prompt: str) -> (C,) aligned text embedding, e.g.
      `lambda p: encode_and_align(encoder, align, p)[0]` with the live
      `TorchCLIPTextEncoder` or a precomputed store
      (query/text_encoder.py).
  res_fn(image (H, W, 3) float [0,1], prompt: str) -> (H, W) bool|None,
      e.g. `TorchRESProvider(GroundingDINOTorch(...), SamTorch(...))
      .predict_mask` (query/res.py).

    app = QueryWebApp(session, text_fn=fn, res_fn=prov.predict_mask)
    app.start()        # daemon thread; open http://host:port
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from goi_tpu_torch.utils.image import write_video
from goi_tpu_torch.viewer.web import _to_jpeg, _to_png, orbit_view_camera

_PAGE = """<!doctype html>
<html><head><title>goi_tpu_torch query app</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif}
 #bar{padding:6px;line-height:2}
 #cv{display:block;cursor:grab}
 input,select,button{background:#222;color:#ddd;border:1px solid #555}
 button{cursor:pointer;padding:1px 8px}
</style></head><body>
<div id=bar>goi_tpu_torch query app &nbsp;
 prompt: <input id=prompt size=24>
 <button onclick="op('set_text',{prompt:prompt.value})">query</button>
 mode: <select id=mode><option>image</option><option>depth</option>
  <option>alpha</option></select>
 <label><input id=ovl type=checkbox checked>overlay</label>
 <br>
 <button onclick="op('retrieve')">retrieve</button>
 <button onclick="op('segment')">segment</button>
 <button onclick="op('delete_view')">del-view</button>
 <button onclick="op('delete_perm')">del-perm</button>
 <button onclick="op('reset')">reset</button>
 move <button onclick="mv(0.1,0,0)">+x</button>
 <button onclick="mv(-0.1,0,0)">-x</button>
 <button onclick="mv(0,0.1,0)">+y</button>
 <button onclick="mv(0,-0.1,0)">-y</button>
 <button onclick="op('finetune',view())">OSH finetune</button>
 <button onclick="op('edit_precompute')">edit-precompute</button>
 <button onclick="op('edit_train',{epochs:5})">edit-train</button>
 <span id=stat></span></div>
<img id=cv width=640 height=480>
<script>
let az=0, el=15, r=3.5, busy=false, dirty=true, url=null;
const img=document.getElementById('cv');
const stat=document.getElementById('stat');
function view(){return {elev:el,azim:az,radius:r,w:640,h:480};}
let drag=false, lx=0, ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>{if(drag){drag=false;dirty=true;}};  // full-res refine on release
window.onmousemove=e=>{if(!drag)return;
 az-=0.4*(e.clientX-lx); el+=0.4*(e.clientY-ly);
 el=Math.max(-89,Math.min(89,el)); lx=e.clientX;ly=e.clientY;
 dirty=true;};
img.onwheel=e=>{e.preventDefault();r*=Math.pow(1.1,e.deltaY>0?1:-1);
 dirty=true;};
function mv(x,y,z){op('move',{delta:[x,y,z]});}
async function op(name,args){
 const res=await fetch('/op',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify(Object.assign({op:name},args||{}))});
 const j=await res.json();
 stat.textContent=' '+JSON.stringify(j);
 dirty=true;}
let gen=0;  // frame generation: a newer request cancels stale refines
async function paint(s,m,o,myGen,t0){
 const u=`/frame?elev=${el}&azim=${az}&radius=${r}&w=640&h=480`+
         `&mode=${m}&overlay=${o}&scale=${s}&fmt=jpeg`;
 const b=await (await fetch(u)).blob();
 if(myGen!==gen)return false;  // superseded while in flight
 if(url)URL.revokeObjectURL(url);
 url=URL.createObjectURL(b);
 img.src=url;
 stat.textContent=` ${(performance.now()-t0).toFixed(0)} ms`+
                  (s<1?' (preview)':'');
 return true;}
async function loop(){
 if(dirty&&!busy){busy=true;dirty=false;
  const m=document.getElementById('mode').value;
  const o=document.getElementById('ovl').checked?1:0;
  const t0=performance.now();
  const myGen=++gen;
  try{
   // progressive refine: the half-size preview paints first, then the
   // full frame replaces it unless the view moved meanwhile
   await paint(0.5,m,o,myGen,t0);
   if(!drag&&myGen===gen&&!dirty)await paint(1,m,o,myGen,t0);
  }catch(e){stat.textContent=' error';}
  busy=false;}
 requestAnimationFrame(loop);}
loop();
</script></body></html>"""


class QueryWebApp:
    """HTTP app around a QuerySession (one lock serializes all session
    access across the handler threads)."""

    def __init__(self, session, *, text_fn: Optional[Callable] = None,
                 res_fn: Optional[Callable] = None, host: str = "0.0.0.0",
                 port: int = 8091, fovy_deg: float = 50.0):
        self.session = session
        self.text_fn = text_fn
        self.res_fn = res_fn
        self.fovy_deg = fovy_deg
        self.prompt: Optional[str] = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._reply(code, "application/json",
                            json.dumps(obj).encode())

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._reply(200, "text/html", _PAGE.encode("utf-8"))
                    elif u.path == "/frame":
                        q = {k: v[0] for k, v in parse_qs(u.query).items()}
                        fmt = q.get("fmt", "png")
                        self._reply(200, f"image/{fmt}", outer._frame(q))
                    elif u.path == "/state":
                        self._json(outer._state())
                    else:
                        self._reply(404, "text/plain", b"not found")
                except Exception as e:  # surface errors to the page
                    self._json({"error": repr(e)}, code=500)

            def do_POST(self):
                u = urlparse(self.path)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    args = json.loads(self.rfile.read(n) or b"{}")
                    if u.path == "/op":
                        self._json(outer._op(args))
                    else:
                        self._reply(404, "text/plain", b"not found")
                except Exception as e:
                    self._json({"error": repr(e)}, code=500)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _cam(self, q: dict):
        return orbit_view_camera(q, self.fovy_deg, self.session.device)

    def _frame(self, q: dict) -> bytes:
        with self._lock:
            img = self.session.render_view(
                self._cam(q), mode=q.get("mode", "image"),
                overlay=q.get("overlay", "1") not in ("0", "false"),
                as_u8=True)
        if q.get("fmt", "png") == "jpeg":
            return _to_jpeg(img)
        return _to_png(img)

    def _state(self) -> dict:
        s = self.session
        with self._lock:
            return {
                "prompt": self.prompt,
                "num_valid": int(s.scene.num_valid),
                "retrieved": (int(s.rel_gs_index.sum())
                              if s.rel_gs_index is not None else None),
                "osh_finetuned": bool(s.res_finetuned),
                "sim_thresh": float(s.sim_thresh),
                "edit": None,
            }

    # ---- operations (the GUI button handlers) ----
    def _op(self, args: dict) -> dict:
        op = args.get("op")
        s = self.session
        with self._lock:
            if op == "set_text":
                if self.text_fn is None:
                    raise ValueError("no text_fn configured")
                self.prompt = str(args["prompt"])
                s.set_text(self.text_fn(self.prompt))
                return {"ok": True, "prompt": self.prompt}
            if op == "retrieve":
                return {"ok": True, "retrieved": int(s.retrieve().sum())}
            if op == "segment":
                s.segment()
                return {"ok": True}
            if op == "delete_view":
                s.delete_view()
                return {"ok": True}
            if op == "delete_perm":
                s.delete_permanently()
                return {"ok": True, "num_valid": int(s.scene.num_valid)}
            if op == "move":
                s.move(args["delta"])
                return {"ok": True}
            if op == "reset":
                s.reset_motion()
                return {"ok": True}
            if op == "finetune":
                cam = self._cam(args)
                mask = args.get("mask")
                if mask is not None:
                    mask = np.asarray(mask, np.float32)
                else:
                    if self.res_fn is None:
                        raise ValueError("no res_fn configured and no "
                                         "mask supplied")
                    img = s.render_view(cam, overlay=False)
                    mask = self.res_fn(img, self.prompt)
                    if mask is None:
                        raise ValueError("RES returned no mask")
                    mask = np.asarray(mask, np.float32)
                iou, epochs = s.finetune_with_res(
                    cam, mask, max_epochs=int(args.get("max_epochs", 8000)))
                return {"ok": True, "iou": iou, "epochs": epochs}
            if op == "group":
                keep = s.group_points(
                    self._cam(args), np.asarray(args["mask"], np.float32),
                    eps=float(args.get("eps", 0.35)),
                    min_samples=int(args.get("min_samples", 600)))
                return {"ok": True, "kept": int(keep.sum())}
            if op == "video":
                anchors = [np.asarray(a, np.float32)
                           for a in args["anchors"]]
                frames = s.render_path(
                    anchors, int(args.get("w", 640)), int(args.get("h", 480)),
                    float(args.get("fovx", 0.9)), float(args.get("fovy", 0.7)),
                    steps_per_segment=int(args.get("steps", 30)),
                    mode=args.get("mode", "image"))
                path = args.get("out", "query_path.mp4")
                write_video(frames, path)
                return {"ok": True, "frames": len(frames), "path": path}
            if op in ("edit_precompute", "edit_train"):
                raise ValueError("no edit session configured")
        raise ValueError(f"unknown op {op!r}")

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"[goi_tpu_torch] query app at http://127.0.0.1:{self.port}")

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

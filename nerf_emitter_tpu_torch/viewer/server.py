"""The web viewer beside (or after) a training run (port of
nerf_emitter_tpu/viewer/server.py): a dependency-free HTTP server and a
single-page client.

- orbit, pan (shift-drag), zoom and field of view;
- render modes rgb | depth | accumulation | normal, spp and resolution,
  low resolution while dragging;
- the run's status and a loss sparkline (/metrics, fed by the Trainer);
- pause, resume and stop (/control; the Trainer polls the flags each step
  and stops with a checkpoint);
- the scene tree (/scene): training-camera frustums, the object AABB and,
  once the takeover fits them, the light clusters;
- keyframes -> a camera-path JSON (/save_path) for
  `scripts/render.py camera-path --camera-path-file`;
- a light-rotation slider: relighting preview by rotating the emitter
  about the object once the takeover state exists.

GET /render?theta=&phi=&radius=&tx=&ty=&tz=&fov=&spp=&mode=&light=&w=&h=
returns an 8-bit PNG rendered from the live pipeline.

The server's threads render on the device while the trainer's thread
steps the same pipeline. The render function holds the pipeline's lock
(`NerfEmitterPipeline.lock`) around each render, as the trainer does
around each step, eval view and save: a CUDA graph capture of the march
(renderer/sphere_trace.py) must not see another thread's CUDA calls, and a
view must not read a state the step is replacing.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..cameras.cameras import Cameras
from ..data.datamanager import ImageDataset
from ..data.synthetic import look_at
from ..renderer.integrator import render_spp
from ..renderer.sensors import camera_rays_in_render_space
from ..utils.math import linear_to_srgb
from ..utils.video import encode_png

_PAGE = """<!doctype html><html><head><title>nerf_emitter_tpu viewer</title>
<style>
body{margin:0;background:#111;color:#eee;font-family:sans-serif;display:flex}
#wrap{position:relative;width:512px;height:512px}
#c{cursor:grab;image-rendering:pixelated;position:absolute;left:0;top:0}
#ov{position:absolute;left:0;top:0;pointer-events:none}
#panel{padding:10px;min-width:250px;font-size:13px;max-height:100vh;overflow-y:auto}
#panel label{display:block;margin-top:8px}
#spark{background:#181818;display:block;margin-top:4px}
button{margin-top:6px}
select,input[type=range]{width:100%}
#tree{margin-top:10px;border-top:1px solid #333;padding-top:6px}
#tree .node{margin-left:10px}
#camlist{max-height:130px;overflow-y:auto;margin-left:22px;color:#9cf}
#camlist div{cursor:pointer}
#camlist div:hover{color:#fff}
.phase{color:#fc6}
</style></head><body>
<div id=wrap>
  <img id=c width=512 height=512>
  <canvas id=ov width=512 height=512></canvas>
</div>
<div id=panel>
  <div>step <span id=step>-</span> &middot; loss <span id=loss>-</span>
    &middot; <span id=phase class=phase>-</span></div>
  <canvas id=spark width=210 height=48></canvas>
  <div>
    <button id=pause>pause training</button>
    <button id=stop>stop + checkpoint</button>
  </div>
  <label>mode <select id=mode>
    <option>rgb</option><option>depth</option>
    <option>accumulation</option><option>normal</option></select></label>
  <label>spp <span id=sppv>4</span>
    <input id=spp type=range min=1 max=32 value=4></label>
  <label>resolution <span id=resv>256</span>
    <input id=res type=range min=64 max=512 step=64 value=256></label>
  <label>fov&deg; <span id=fovv>40</span>
    <input id=fov type=range min=15 max=90 value=40></label>
  <label>light rotation&deg; <span id=lightv>0</span>
    <input id=light type=range min=0 max=360 value=0></label>
  <button id=key>add keyframe (<span id=nkey>0</span>)</button>
  <button id=exp>export camera path</button>
  <div id=tree><b>scene</b>
    <div class=node><label><input type=checkbox id=showcams>
      cameras (<span id=ncams>0</span>) — click to jump</label>
      <div id=camlist></div></div>
    <div class=node><label><input type=checkbox id=showaabb>
      object AABB</label></div>
    <div class=node><label><input type=checkbox id=showlights>
      light clusters (<span id=nlights>0</span>)</label></div>
  </div>
  <div style="margin-top:10px;color:#888">drag orbit &middot; shift-drag pan
  &middot; wheel zoom</div>
</div>
<script>
let th=0.5, ph=0.4, r=2.4, t=[0,0,0], busy=false, drag=false, dirty=true;
let scene=null, paused=false;
const $=id=>document.getElementById(id);
const img=$('c');
const keys=[];
function params(w){
  return `theta=${th}&phi=${ph}&radius=${r}&tx=${t[0]}&ty=${t[1]}&tz=${t[2]}`+
    `&fov=${$('fov').value}&spp=${drag?1:$('spp').value}`+
    `&mode=${$('mode').value}&light=${$('light').value}&w=${w}&h=${w}`;
}
function load(){ if(busy||!dirty) return; busy=true; dirty=false;
  const w = drag ? 128 : +$('res').value;
  const u=`/render?`+params(w);
  const i=new Image();
  i.onload=()=>{img.src=u; busy=false; overlay(); if(dirty) load();};
  i.onerror=()=>{busy=false;};
  i.src=u; }
function mark(){ dirty=true; overlay(); load(); }
// ---- scene-tree overlays: project world points through the SAME
// look-at/pinhole model the server renders with (data/synthetic.look_at:
// forward=target-eye, right=fwd x up, up'=right x fwd; u=W/2+f*x/z).
function basis(){
  const eye=[t[0]+r*Math.cos(th)*Math.cos(ph), t[1]+r*Math.sin(ph),
             t[2]+r*Math.sin(th)*Math.cos(ph)];
  let f=[t[0]-eye[0],t[1]-eye[1],t[2]-eye[2]];
  const nf=Math.hypot(...f); f=f.map(v=>v/nf);
  // right = fwd x up with up=(0,1,0) => (-fz, 0, fx)
  let rg=[-f[2],0,f[0]];
  const nr=Math.hypot(...rg)||1; rg=rg.map(v=>v/nr);
  const up=[rg[1]*f[2]-rg[2]*f[1], rg[2]*f[0]-rg[0]*f[2],
            rg[0]*f[1]-rg[1]*f[0]]; // right x fwd
  return {eye,f,rg,up};
}
function project(p,B,W){
  const d=[p[0]-B.eye[0],p[1]-B.eye[1],p[2]-B.eye[2]];
  const z=d[0]*B.f[0]+d[1]*B.f[1]+d[2]*B.f[2];
  if(z<=1e-6) return null;
  const fpx=0.5*W/Math.tan((+$('fov').value)*Math.PI/360);
  const x=d[0]*B.rg[0]+d[1]*B.rg[1]+d[2]*B.rg[2];
  const y=d[0]*B.up[0]+d[1]*B.up[1]+d[2]*B.up[2];
  return [W/2+fpx*x/z, W/2-fpx*y/z];
}
function seg(c,B,W,a,b){const pa=project(a,B,W),pb=project(b,B,W);
  if(pa&&pb){c.beginPath();c.moveTo(pa[0],pa[1]);c.lineTo(pb[0],pb[1]);c.stroke();}}
function overlay(){
  const cv=$('ov'), c=cv.getContext('2d'), W=512;
  c.clearRect(0,0,W,W);
  if(!scene) return;
  const B=basis();
  if($('showcams').checked && scene.cameras){
    c.strokeStyle='#5d5';c.lineWidth=1;
    for(const m of scene.cameras){ // m = 3x4 c2w (OpenGL: -z forward)
      const o=[m[0][3],m[1][3],m[2][3]];
      const s=0.12*r;
      const fw=[-m[0][2],-m[1][2],-m[2][2]],
            rt=[m[0][0],m[1][0],m[2][0]], upv=[m[0][1],m[1][1],m[2][1]];
      const corners=[];
      for(const [sx,sy] of [[-1,-1],[1,-1],[1,1],[-1,1]])
        corners.push([0,1,2].map(i=>o[i]+s*(fw[i]+0.5*sx*rt[i]+0.5*sy*upv[i])));
      for(let i=0;i<4;i++){ seg(c,B,W,o,corners[i]);
        seg(c,B,W,corners[i],corners[(i+1)%4]); }
    }
  }
  if($('showaabb').checked && scene.aabb){
    c.strokeStyle='#fa4';c.lineWidth=1;
    const [lo,hi]=scene.aabb;
    const v=[[lo[0],lo[1],lo[2]],[hi[0],lo[1],lo[2]],[hi[0],hi[1],lo[2]],
             [lo[0],hi[1],lo[2]],[lo[0],lo[1],hi[2]],[hi[0],lo[1],hi[2]],
             [hi[0],hi[1],hi[2]],[lo[0],hi[1],hi[2]]];
    for(const [a,b] of [[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
                        [0,4],[1,5],[2,6],[3,7]]) seg(c,B,W,v[a],v[b]);
  }
  if($('showlights').checked && scene.lights){
    const ws=scene.lights.weights, mx=Math.max(...ws,1e-9);
    c.fillStyle='#ff6';
    scene.lights.positions.forEach((p,i)=>{
      const q=project(p,B,512); if(!q) return;
      const rad=2+6*Math.sqrt(ws[i]/mx);
      c.beginPath();c.arc(q[0],q[1],rad,0,6.3);c.fill();});
  }
}
async function loadScene(){
  try{ scene=await (await fetch('/scene')).json(); }catch(e){ return; }
  $('ncams').innerText=(scene.cameras||[]).length;
  $('nlights').innerText=scene.lights?scene.lights.positions.length:0;
  $('phase').innerText=scene.phase||'-';
  const cl=$('camlist'); cl.innerHTML='';
  (scene.cameras||[]).forEach((m,i)=>{
    const d=document.createElement('div'); d.textContent='cam '+i;
    d.onclick=()=>{ // jump to this camera's pose: eye=c2w[:,3], look -z
      const eye=[m[0][3],m[1][3],m[2][3]];
      const fw=[-m[0][2],-m[1][2],-m[2][2]];
      r=Math.hypot(eye[0]-t[0],eye[1]-t[1],eye[2]-t[2]);
      t=[eye[0]+fw[0]*r, eye[1]+fw[1]*r, eye[2]+fw[2]*r];
      const o=[eye[0]-t[0],eye[1]-t[1],eye[2]-t[2]];
      ph=Math.asin(Math.max(-1,Math.min(1,o[1]/r)));
      th=Math.atan2(o[2],o[0]); mark(); };
    cl.appendChild(d); });
  overlay();
}
for(const id of ['showcams','showaabb','showlights'])
  $(id).onchange=overlay;
$('pause').onclick=async()=>{
  paused=!paused;
  await fetch('/control',{method:'POST',
    body:JSON.stringify({action:paused?'pause':'resume'})});
  $('pause').innerText=paused?'resume training':'pause training'; };
$('stop').onclick=async()=>{
  if(!confirm('stop training and write a checkpoint?')) return;
  await fetch('/control',{method:'POST',
    body:JSON.stringify({action:'stop'})}); };
let lx=0,ly=0,pan=false;
img.onmousedown=e=>{drag=true;pan=e.shiftKey;lx=e.x;ly=e.y};
window.onmouseup=()=>{if(drag){drag=false;mark();}};
window.onmousemove=e=>{if(!drag)return;
  const dx=e.x-lx, dy=e.y-ly; lx=e.x; ly=e.y;
  if(pan){const s=r*0.002;
    t[0]-=s*(dx*Math.sin(th)); t[2]+=s*(dx*Math.cos(th)); t[1]+=s*dy;}
  else {th+=dx*0.01; ph+=dy*0.01; ph=Math.max(-1.4,Math.min(1.4,ph));}
  mark();};
window.onwheel=e=>{r*=e.deltaY>0?1.1:0.9; mark();};
for(const id of ['mode','spp','res','fov','light'])
  $(id).oninput=()=>{ $('sppv').innerText=$('spp').value;
    $('resv').innerText=$('res').value; $('fovv').innerText=$('fov').value;
    $('lightv').innerText=$('light').value; mark(); };
$('key').onclick=()=>{ keys.push({theta:th,phi:ph,radius:r,
  target:[...t],fov:+$('fov').value}); $('nkey').innerText=keys.length; };
$('exp').onclick=async()=>{
  const res=await fetch('/save_path',{method:'POST',
    body:JSON.stringify({keyframes:keys,n_frames:keys.length*24})});
  alert(await res.text()); };
let lastPhase=null;
async function poll(){
  try{
    const m=await (await fetch('/metrics')).json();
    $('step').innerText=m.step;
    if(m.phase!==lastPhase){ lastPhase=m.phase; loadScene(); }
    if(m.losses.length){ $('loss').innerText=m.losses.at(-1)[1].toFixed(4);
      const c=$('spark').getContext('2d'); c.clearRect(0,0,210,48);
      const vs=m.losses.map(p=>p[1]);
      const lo=Math.min(...vs), hi=Math.max(...vs)+1e-12;
      c.strokeStyle='#6cf'; c.beginPath();
      vs.forEach((v,i)=>{const x=i/(vs.length-1||1)*208+1,
        y=46-(v-lo)/(hi-lo)*44; i?c.lineTo(x,y):c.moveTo(x,y);});
      c.stroke(); }
  }catch(e){}
  setTimeout(poll, 2000); }
mark(); loadScene(); poll(); setInterval(()=>{dirty=true;load();}, 5000);
</script></body></html>"""

MODES = ("rgb", "depth", "accumulation", "normal")


class ViewerState:
    """The handle the trainer updates and the server reads."""

    def __init__(self, render_fn, scene_radius: float = 2.4, save_dir: Optional[Path] = None, scene_fn=None):
        # render_fn(theta, phi, radius, w, h, target, fov_deg, spp, mode,
        #           light_angle) -> (h, w, 3) float radiance or visualisation
        self.render_fn = render_fn
        self.scene_radius = scene_radius
        self.step = 0
        self.losses: deque = deque(maxlen=200)  # (step, loss)
        self.save_dir = Path(save_dir) if save_dir else Path(".")
        # scene_fn() -> {"cameras": [3x4 c2w...], "aabb": [lo, hi],
        #   "lights": {"positions": [...], "weights": [...]}, "phase": str},
        # read live, so the light clusters appear once the takeover fits them
        self.scene_fn = scene_fn
        self.phase = None  # "nerf" | "sdf", set by the trainer
        # the trainer polls these each step
        self.paused = False
        self.stop_requested = False
        # the last render's wall time and its wait for the pipeline's lock
        self.render_ms: Optional[float] = None
        self.lock_wait_ms: Optional[float] = None

    def put_metrics(self, step: int, metrics: dict) -> None:
        self.step = step
        loss = metrics.get("loss")
        if loss is not None and np.isfinite(loss):
            self.losses.append((int(step), float(loss)))

    def control(self, action: str) -> dict:
        if action == "pause":
            self.paused = True
        elif action == "resume":
            self.paused = False
        elif action == "stop":
            self.stop_requested = True
            self.paused = False
        else:
            raise ValueError(f"unknown control action {action!r}")
        return {"paused": self.paused, "stop": self.stop_requested}


def orbit_eye(theta: float, phi: float, radius: float, target) -> np.ndarray:
    """The eye on the orbit sphere about `target` (float32)."""
    tgt = np.asarray(target, np.float32)
    return tgt + radius * np.array([np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)],
                                   np.float32)


def keyframes_to_camera_path(payload: dict) -> dict:
    """Viewer keyframes -> the camera-path JSON of `scripts/render.py
    camera-path --camera-path-file` ({"keyframes": [{"c2w": 3x4,
    "fov_deg": f}], "n_frames": N})."""
    out = []
    for k in payload.get("keyframes", []):
        target = np.asarray(k.get("target", (0, 0, 0)), np.float32)
        c2w = look_at(orbit_eye(k["theta"], k["phi"], k["radius"], target), target)[:3]
        out.append({"c2w": np.asarray(c2w).tolist(), "fov_deg": float(k.get("fov", 40.0))})
    return {"keyframes": out, "n_frames": int(payload.get("n_frames", max(1, len(out)) * 24))}


def visualize(image: np.ndarray, mode: str) -> bytes:
    """A render_fn's (h, w, 3) output -> PNG bytes: rgb tonemapped to sRGB,
    the other modes clipped to [0, 1]."""
    if mode == "rgb":
        vis = linear_to_srgb(torch.as_tensor(np.asarray(image, np.float32))).numpy()
    else:
        vis = np.clip(image, 0.0, 1.0)
    return encode_png((vis * 255).astype(np.uint8))


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # no line per request
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/save_path":
                try:
                    path_json = keyframes_to_camera_path(self._json_body())
                    if not path_json["keyframes"]:
                        self._send(b"no keyframes set", "text/plain", 400)
                        return
                    out = state.save_dir / "camera_path.json"
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_text(json.dumps(path_json, indent=1))
                    msg = (f"wrote {out} — render with:\n"
                           "python -m nerf_emitter_tpu_torch.scripts.render camera-path "
                           f"--camera-path-file {out} --load-config <run>/config.json")
                    self._send(msg.encode(), "text/plain")
                except (ValueError, KeyError, TypeError, OSError) as e:
                    self._send(str(e).encode(), "text/plain", 500)
                return
            if url.path == "/control":
                try:
                    out = state.control(self._json_body().get("action", ""))
                    self._send(json.dumps(out).encode(), "application/json")
                except ValueError as e:
                    self._send(str(e).encode(), "text/plain", 400)
                return
            self._send(b"not found", "text/plain", 404)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif url.path == "/status":
                self._send(json.dumps({"step": state.step}).encode(), "application/json")
            elif url.path == "/metrics":
                self._send(json.dumps({"step": state.step, "losses": list(state.losses), "phase": state.phase,
                                       "paused": state.paused, "render_ms": state.render_ms,
                                       "lock_wait_ms": state.lock_wait_ms}).encode(), "application/json")
            elif url.path == "/scene":
                try:
                    info = state.scene_fn() if state.scene_fn else {}
                except Exception as e:  # the scene's error -> 500 with its message
                    self._send(str(e).encode(), "text/plain", 500)
                    return
                self._send(json.dumps(info).encode(), "application/json")
            elif url.path == "/render":
                self._render(parse_qs(url.query))
            else:
                self._send(b"not found", "text/plain", 404)

        def _render(self, q: dict):
            def f(name, default):
                return float(q.get(name, [default])[0])

            mode = q.get("mode", ["rgb"])[0]
            mode = mode if mode in MODES else "rgb"
            w, h = min(int(f("w", 256)), 1024), min(int(f("h", 256)), 1024)
            t0 = time.perf_counter()
            try:
                img = np.asarray(state.render_fn(
                    f("theta", 0.5), f("phi", 0.4), f("radius", state.scene_radius), w, h,
                    target=(f("tx", 0.0), f("ty", 0.0), f("tz", 0.0)), fov_deg=f("fov", 40.0),
                    spp=max(1, min(int(f("spp", 4)), 64)), mode=mode, light_angle=f("light", 0.0) * np.pi / 180.0))
            except Exception as e:  # a render's error -> 500 with its message
                self._send(str(e).encode(), "text/plain", 500)
                return
            state.render_ms = (time.perf_counter() - t0) * 1e3
            state.lock_wait_ms = getattr(state.render_fn, "lock_wait_ms", None)
            self._send(visualize(img, mode), "image/png")

    return Handler


def start_viewer(state: ViewerState, port: int = 7007) -> ThreadingHTTPServer:
    """Serve the viewer from a daemon thread; returns the server."""
    server = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://localhost:{server.server_address[1]}", flush=True)
    return server


def orbit_cameras(theta, phi, radius, w, h, target=(0.0, 0.0, 0.0), fov_deg=40.0, device=None) -> Cameras:
    """The viewer's pinhole camera on the orbit (look_at the target, focal
    length from the horizontal field of view)."""
    tgt = np.asarray(target, np.float32)
    c2w = look_at(orbit_eye(theta, phi, radius, tgt), tgt)[:3]
    f = 0.5 * w / np.tan(np.deg2rad(fov_deg) / 2.0)
    full = lambda v: torch.full((1,), float(v), device=device)  # noqa: E731
    return Cameras(camera_to_worlds=torch.as_tensor(np.asarray(c2w, np.float32)[None], device=device), fx=full(f),
                   fy=full(f), cx=full(w / 2), cy=full(h / 2), width=w, height=h)


def make_orbit_render_fn(pipeline, dataset: ImageDataset, default_spp: int = 4):
    """The viewer's render_fn on the live pipeline: render_camera_outputs
    (the NeRF before the takeover, the SDF scene lit by the NeRF after it)
    from a generator seeded 0, on this rank alone (no collective: the
    viewer lives on rank 0), under the pipeline's lock and torch.no_grad().
    A non-zero light_angle rotates the NeRF emitter about +y around the
    object's centre for a relighting preview (the reference's
    set_light_axis_angle). The function's `lock_wait_ms` is its last wait
    for the lock."""
    dev = pipeline.device

    def render(theta, phi, radius, w, h, target=(0.0, 0.0, 0.0), fov_deg=40.0, spp=None, mode="rgb",
               light_angle=0.0):
        spp = default_spp if spp is None else spp
        cams = orbit_cameras(theta, phi, radius, w, h, target, fov_deg, device=dev)
        t0 = time.perf_counter()
        with pipeline.lock, torch.no_grad():
            render.lock_wait_ms = (time.perf_counter() - t0) * 1e3
            gen = torch.Generator(device=dev).manual_seed(0)
            if light_angle != 0.0 and pipeline.sdf_state is not None:
                base = pipeline._emitter_fn_of(pipeline.model)
                c, s = float(np.cos(light_angle)), float(np.sin(light_angle))
                rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], device=dev)
                center = torch.full((3,), 0.5, device=dev)

                def rotated(x, d):
                    return base((x - center) @ rot.T + center, d @ rot.T)

                o, d = camera_rays_in_render_space(cams, 0, h, w, pipeline.config.scene_scale)
                raw = render_spp(pipeline.sdf_state.scene, o, d, spp, gen, emitter_fn=rotated,
                                 config=pipeline.render_config)
                out = {"rgb": raw["rgb"].reshape(h, w, 3), "depth": raw["depth"].reshape(h, w, 1),
                       "normal": raw["normal"].reshape(h, w, 3), "accumulation": raw["soft_mask"].reshape(h, w, 1)}
            else:
                ds = ImageDataset(cameras=cams, images=dataset.images[:1], is_hdr=True)
                out = pipeline.render_camera_outputs(ds, 0, gen, spp=spp, collective=False)
            out = {k: v.float().cpu().numpy() for k, v in out.items() if v is not None}
        if mode == "rgb" or out.get(mode) is None:
            return out["rgb"]
        v = out[mode]
        if mode == "depth":
            d = v[..., 0]
            lo, hi = np.percentile(d, 2), np.percentile(d, 98)
            v = ((d - lo) / max(hi - lo, 1e-6))[..., None]
            return np.repeat(np.clip(v, 0, 1), 3, axis=-1)
        if mode == "accumulation":
            return np.repeat(np.clip(v, 0, 1), 3, axis=-1)
        return 0.5 * (v + 1.0)  # normal

    render.lock_wait_ms = None
    return render

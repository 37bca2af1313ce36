"""The live web viewer (port of kintinuous_tpu/viz/server.py) — the
reference's PangoVis without a display.

PangoVis (src/PangoVis.{h,cpp}) draws the map, the trajectory's frusta,
four image panes and a stats panel in a GL window, with buttons that
call into MainController (complete, save, reset, pause,
PangoVis.cpp:533-556). Here the same signals are served over HTTP from
a background thread to a self-contained page that draws the cloud on a
2D canvas:

    GET  /            the page (the JAX package's, byte for byte)
    GET  /state.json  stats panel and trajectory (PangoVis.cpp:584-600)
    GET  /cloud.bin   decimated global map [u32 n][f32 xyz * n][u8 rgb * n]
    GET  /mesh.bin    the welded incremental mesh
    GET  /pane/{rgb|depth|model|model_depth}.png   the four image panes
    POST /control     {"cmd": complete|save|reset|pause}
                      (MainController.cpp:233-361)

The model panes render the tracker's current prediction on its device
(ops/image.py); the panes are PNGs from viz/png.py. The frame loop
updates the volume in place, so `save` and `reset` run on a thread of
their own under the engine's frame lock, between two frames; a pane
needs only the state's prediction maps, which each step replaces.
Start with `ViewerServer(engine)` or the CLI's `--viz-port`.
"""

from __future__ import annotations

import contextlib
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kintinuous_tpu_torch.viz.headless import MODEL_PANES, model_view
from kintinuous_tpu_torch.viz.png import TURBO, encode_png

MAX_VIEW_POINTS = 300_000
MAX_VIEW_FACES = 60_000

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>kintinuous_tpu</title>
<style>
 body{margin:0;background:#0b0e14;color:#cdd6f4;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0b0e14cc;padding:8px 12px;
      border:1px solid #2a2f3a;border-radius:6px;white-space:pre}
 #bar{position:fixed;top:8px;right:8px}
 button{background:#1c2330;color:#cdd6f4;border:1px solid #2a2f3a;
        border-radius:4px;padding:4px 10px;margin-left:6px;font:12px monospace;cursor:pointer}
 button:hover{background:#2a3342}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">connecting…</div>
<div id="panes" style="position:fixed;bottom:8px;left:8px">
 <img id="p_rgb" width="160" style="border:1px solid #2a2f3a;margin-right:4px">
 <img id="p_depth" width="160" style="border:1px solid #2a2f3a;margin-right:4px">
 <img id="p_model" width="160" style="border:1px solid #2a2f3a;margin-right:4px">
 <img id="p_model_depth" width="160" style="border:1px solid #2a2f3a">
</div>
<div id="bar">
 <button onclick="showMesh=!showMesh">mesh</button>
 <button onclick="ctl('pause')">pause</button>
 <button onclick="ctl('complete')">complete</button>
 <button onclick="ctl('save')">save</button>
 <button onclick="ctl('reset')">reset</button>
</div>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight}rs();onresize=rs;
let pts=null,cols=null,traj=[],nCloud=0,frusta=[];
let mV=null,mC=null,mF=null,mNF=0,showMesh=true,lastT=-1;
let yaw=-0.6,pitch=-0.4,dist=6,tgt=[0,0,0],drag=0,lx=0,ly=0;
cv.onmousedown=e=>{drag=e.button===0?1:2;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=0;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(drag===1){yaw+=dx*0.005;pitch+=dy*0.005}else{
  const s=dist*0.002;tgt[0]-=dx*s*Math.cos(yaw);tgt[2]-=dx*s*Math.sin(yaw);tgt[1]+=dy*s}};
cv.oncontextmenu=e=>e.preventDefault();
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);dist=Math.max(0.5,Math.min(80,dist))};
function draw(){
 cx.fillStyle='#0b0e14';cx.fillRect(0,0,W,H);
 const cp=Math.cos(pitch),sp=Math.sin(pitch),cy_=Math.cos(yaw),sy=Math.sin(yaw);
 const ex=tgt[0]+dist*cp*sy, ey=tgt[1]+dist*sp, ez=tgt[2]+dist*cp*cy_;
 // camera basis
 let fz=[tgt[0]-ex,tgt[1]-ey,tgt[2]-ez];const fl=Math.hypot(...fz);fz=fz.map(v=>v/fl);
 let rx=[fz[2],0,-fz[0]];const rl=Math.hypot(...rx)||1;rx=rx.map(v=>v/rl);
 const up=[rx[1]*fz[2]-rx[2]*fz[1],rx[2]*fz[0]-rx[0]*fz[2],rx[0]*fz[1]-rx[1]*fz[0]];
 const f=0.9*H;
 function prj(x,y,z){
  x-=ex;y-=ey;z-=ez;
  const cz=x*fz[0]+y*fz[1]+z*fz[2];
  if(cz<0.05)return null;
  return [W/2+f*(x*rx[0]+y*rx[1]+z*rx[2])/cz, H/2-f*(x*up[0]+y*up[1]+z*up[2])/cz];
 }
 if(pts){const id=cx.getImageData(0,0,W,H),d=id.data;
  for(let i=0;i<nCloud;i++){
   const p=prj(pts[3*i],pts[3*i+1],pts[3*i+2]);if(!p)continue;
   const px=p[0]|0,py=p[1]|0;if(px<0||py<0||px>=W||py>=H)continue;
   const o=4*(py*W+px);d[o]=cols[3*i];d[o+1]=cols[3*i+1];d[o+2]=cols[3*i+2];d[o+3]=255;}
  cx.putImageData(id,0,0);}
 if(showMesh&&mV&&mF){ // painter-sorted flat triangles (PangoVis mesh draw role)
  const tris=[];
  for(let i=0;i<mNF;i++){
   const a=mF[3*i],b=mF[3*i+1],c=mF[3*i+2];
   const pa=prj(mV[3*a],mV[3*a+1],mV[3*a+2]);if(!pa)continue;
   const pb=prj(mV[3*b],mV[3*b+1],mV[3*b+2]);if(!pb)continue;
   const pc=prj(mV[3*c],mV[3*c+1],mV[3*c+2]);if(!pc)continue;
   const zc=(mV[3*a]-ex)*fz[0]+(mV[3*a+1]-ey)*fz[1]+(mV[3*a+2]-ez)*fz[2];
   tris.push([zc,pa,pb,pc,a]);}
  tris.sort((u,v)=>v[0]-u[0]);
  for(const t of tris){const a=t[4];
   cx.fillStyle=`rgb(${mC[3*a]},${mC[3*a+1]},${mC[3*a+2]})`;
   cx.beginPath();cx.moveTo(t[1][0],t[1][1]);cx.lineTo(t[2][0],t[2][1]);
   cx.lineTo(t[3][0],t[3][1]);cx.closePath();cx.fill();}}
 if(traj.length>1){cx.strokeStyle='#7dd3a0';cx.lineWidth=1.5;cx.beginPath();let m=0;
  for(const q of traj){const p=prj(q[0],q[1],q[2]);if(!p){m=0;continue}
   m?cx.lineTo(p[0],p[1]):cx.moveTo(p[0],p[1]);m=1}cx.stroke();
  const last=traj[traj.length-1],p=prj(last[0],last[1],last[2]);
  if(p){cx.fillStyle='#f38ba8';cx.beginPath();cx.arc(p[0],p[1],4,0,7);cx.fill()}}
 // camera frusta along the trajectory (PangoVis.cpp:421-436 role)
 for(let k=0;k<frusta.length;k++){
  const M=frusta[k],sc=k===frusta.length-1?0.22:0.1;
  cx.strokeStyle=k===frusta.length-1?'#f38ba8':'#89b4fa';cx.lineWidth=1;
  const o=[M[3],M[7],M[11]];
  const corn=[[-1,-0.75,1.5],[1,-0.75,1.5],[1,0.75,1.5],[-1,0.75,1.5]].map(q=>[
   o[0]+sc*(M[0]*q[0]+M[1]*q[1]+M[2]*q[2]),
   o[1]+sc*(M[4]*q[0]+M[5]*q[1]+M[6]*q[2]),
   o[2]+sc*(M[8]*q[0]+M[9]*q[1]+M[10]*q[2])]);
  const po=prj(o[0],o[1],o[2]);if(!po)continue;
  const pc2=corn.map(q=>prj(q[0],q[1],q[2]));if(pc2.some(p=>!p))continue;
  cx.beginPath();
  for(const p of pc2){cx.moveTo(po[0],po[1]);cx.lineTo(p[0],p[1]);}
  cx.moveTo(pc2[0][0],pc2[0][1]);
  for(let i2=1;i2<=4;i2++){const p=pc2[i2%4];cx.lineTo(p[0],p[1]);}
  cx.stroke();}
 requestAnimationFrame(draw);
}
requestAnimationFrame(draw);
async function ctl(cmd){await fetch('/control',{method:'POST',body:JSON.stringify({cmd})});}
let lastN=-1;
async function poll(){
 try{
  const s=await (await fetch('/state.json')).json();
  document.getElementById('hud').textContent=
   `frame   ${s.frame}\\nfps     ${s.fps.toFixed(1)}\\npoints  ${s.n_points}`+
   `\\ntris    ${s.n_triangles}`+
   `\\nslices  ${s.n_slices}\\nloops   ${s.n_loops}\\nlag     ${s.backend_lag_s.toFixed(2)} s`+
   `\\nstatus  ${s.status}`;
  traj=s.traj;frusta=s.frusta||[];
  for(const nm of ['rgb','depth','model','model_depth'])
   document.getElementById('p_'+nm).src='/pane/'+nm+'.png?t='+Date.now();
  if(s.n_triangles!==lastT){lastT=s.n_triangles;
   if(s.n_triangles>0){
    const b=await (await fetch('/mesh.bin')).arrayBuffer();
    const nv=new Uint32Array(b,0,1)[0];
    mV=new Float32Array(b.slice(4,4+12*nv));
    mC=new Uint8Array(b,4+12*nv,3*nv);
    const o2=4+12*nv+3*nv+((4-(4+12*nv+3*nv)%4)%4);
    mNF=new Uint32Array(b.slice(o2,o2+4))[0];
    mF=new Uint32Array(b.slice(o2+4,o2+4+12*mNF));
   }else{mV=mC=mF=null;mNF=0;}}
  if(s.n_points!==lastN){lastN=s.n_points;
   const b=await (await fetch('/cloud.bin')).arrayBuffer();
   const n=new Uint32Array(b,0,1)[0];
   pts=new Float32Array(b,4,n*3);
   cols=new Uint8Array(b,4+12*n,n*3);nCloud=n;
   if(n>0&&traj.length===0){tgt=[pts[0],pts[1],pts[2]]}}
 }catch(e){}
 setTimeout(poll,500);
}
poll();
</script></body></html>"""


class ViewerServer:
    """Serves the live viewer for a SlamEngine on a background thread;
    port 0 takes a free one (`self.port`)."""

    def __init__(self, engine, port: int = 8090, host: str = "127.0.0.1"):
        self.engine = engine
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no line a request on stderr
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path.startswith("/state.json"):
                    self._send(200, "application/json", json.dumps(viewer.state()).encode())
                elif self.path.startswith("/cloud.bin"):
                    self._send(200, "application/octet-stream", viewer.cloud_bin())
                elif self.path.startswith("/mesh.bin"):
                    self._send(200, "application/octet-stream", viewer.mesh_bin())
                elif self.path.startswith("/pane/"):
                    name = self.path.split("/pane/")[1].split(".")[0]
                    png = viewer.pane_png(name)
                    if png is None:
                        self._send(404, "text/plain", b"no pane")
                    else:
                        self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.startswith("/control"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        cmd = json.loads(self.rfile.read(n)).get("cmd", "")
                    except (ValueError, AttributeError):  # not a JSON object
                        cmd = ""
                    ok = viewer.control(cmd)
                    self._send(200, "application/json",
                               json.dumps({"ok": ok, "cmd": cmd}).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ data
    def state(self) -> dict:
        e = self.engine
        slices = e.slice_proc.processed
        n_points = sum(len(s.processed["points"]) for s in slices if s.processed)
        n_loops = e.deformation.n_loops_accepted if e.deformation is not None else 0
        poses = e.tracker.poses
        step = max(1, len(poses) // 2000)
        traj = [[float(T[0, 3]), float(T[1, 3]), float(T[2, 3])] for T in poses[::step]]
        # the backpressure: the largest stage lag gauge (now - the source's
        # wall clock, ThreadObject.h:69, PangoVis.cpp:597-599)
        lag = e.sw.max_gauge("lag.") / 1e3
        status = "paused" if getattr(e, "paused", None) and e.paused.is_set() \
            else ("finished" if e._end_of_log.is_set() else "tracking")
        # camera frusta: the latest pose and up to 24 spaced along the run
        # (PangoVis.cpp:421-436)
        fr = []
        if poses:
            fstep = max(1, len(poses) // 24)
            sel = list(range(0, len(poses), fstep))
            if sel[-1] != len(poses) - 1:
                sel.append(len(poses) - 1)
            for k in sel:
                fr.append([float(v) for v in np.asarray(poses[k])[:3, :4].reshape(-1)])
        return {
            "frame": len(poses),
            "fps": e.fps,
            "n_points": int(n_points),
            "n_slices": len(slices),
            "n_loops": int(n_loops),
            "n_triangles": int(self._mesh_tris()),
            "backend_lag_s": lag,
            "status": status,
            "traj": traj,
            "frusta": fr,
        }

    def _mesh_patches(self):
        e = self.engine
        if e.deformation is not None and e.deformation.mesh_patches:
            return e.deformation.mesh_patches
        return getattr(e.tracker, "mesh_patches", []) or []

    def _mesh_tris(self) -> int:
        return sum(len(p.faces) for p in self._mesh_patches())

    def mesh_bin(self) -> bytes:
        """[u32 nv][f32 xyz*nv][u8 rgb*nv][pad4][u32 nf][u32 abc*nf] of
        the cell-welded incremental mesh (PangoVis.cpp:343-390), at most
        MAX_VIEW_FACES faces."""
        from kintinuous_tpu_torch.backend.meshing import weld_patches

        patches = [p for p in self._mesh_patches() if len(p.vertices)]
        if not patches:
            return struct.pack("<I", 0)
        if all(p.cells is not None for p in patches):
            verts, cols, faces = weld_patches(patches)
        else:
            vs, cs, fs, off = [], [], [], 0
            for p in patches:
                vs.append(p.vertices)
                cs.append(p.colors)
                fs.append(p.faces + off)
                off += len(p.vertices)
            verts, cols, faces = np.concatenate(vs), np.concatenate(cs), np.concatenate(fs)
        if len(faces) > MAX_VIEW_FACES:
            idx = np.random.default_rng(0).choice(len(faces), MAX_VIEW_FACES, replace=False)
            faces = faces[idx]
        body = (struct.pack("<I", len(verts)) + verts.astype(np.float32).tobytes()
                + cols[:, :3].astype(np.uint8).tobytes())
        body += b"\x00" * ((4 - len(body) % 4) % 4)
        body += struct.pack("<I", len(faces)) + faces.astype(np.uint32).tobytes()
        return body

    def cloud_bin(self) -> bytes:
        """[u32 n][f32 xyz * n][u8 rgb * n] of the decimated global map:
        the deformed pool once a loop was applied, else the processed
        slices."""
        e = self.engine
        pts_list, col_list = [], []
        if e.deformation is not None and e.deformation.n_loops_accepted:
            pool = e.deformation.pool_points()
            if pool is not None and len(pool[0]):
                pts_list, col_list = [pool[0]], [pool[1]]
        if not pts_list:
            for s in e.slice_proc.processed:
                if s.processed is not None and len(s.processed["points"]):
                    pts_list.append(s.processed["points"])
                    col_list.append(s.processed["colors"])
        if not pts_list:
            return struct.pack("<I", 0)
        pts = np.concatenate(pts_list).astype(np.float32)
        cols = np.concatenate(col_list).astype(np.uint8)
        if len(pts) > MAX_VIEW_POINTS:
            idx = np.random.default_rng(0).choice(len(pts), MAX_VIEW_POINTS, replace=False)
            pts, cols = pts[idx], cols[idx]
        return struct.pack("<I", len(pts)) + pts.tobytes() + cols[:, :3].tobytes()

    def pane_png(self, name: str):
        """The reference's four image panes (PangoVis.cpp:45-80) as PNG
        bytes: the last input's colour and its depth (Turbo over 0-6 m),
        the shaded model prediction and the prediction's depth; None for
        an unknown pane or one with nothing to show."""
        e = self.engine
        last = e.last_frame
        img = None
        if name == "rgb" and last is not None and last[1] is not None:
            img = np.asarray(last[1])
        elif name == "depth" and last is not None:
            d = np.asarray(last[0]).astype(np.float32)
            img = TURBO[np.clip(d / 6000.0 * 255, 0, 255).astype(np.uint8)]
        elif name in MODEL_PANES and e.tracker.state is not None:
            # the tracker updates its state in place on its own stream:
            # render between two frames (an engine without a frame loop
            # has no lock)
            with getattr(e, "frame_lock", None) or contextlib.nullcontext():
                img = model_view(e.tracker, name)
        return None if img is None else encode_png(img)

    # --------------------------------------------------------- control
    def _at_frame_boundary(self, fn):
        with self.engine.frame_lock:
            fn()

    def control(self, cmd: str) -> bool:
        e = self.engine
        if cmd == "complete":
            e.complete()
            return True
        if cmd in ("save", "reset"):
            # between two frames: the frame loop holds the lock for each
            threading.Thread(target=self._at_frame_boundary, args=(getattr(e, cmd),),
                             daemon=True).start()
            return True
        if cmd == "pause":
            if hasattr(e, "paused"):
                if e.paused.is_set():
                    e.paused.clear()
                else:
                    e.paused.set()
                return True
            return False
        return False

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=3.0)

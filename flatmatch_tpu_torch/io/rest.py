"""FlatMatch REST folder-tree packager and server.

Copy of flatmatch_tpu/io/rest.py, the counterpart of the reference's
packaging script (generate_flatmatch_entry.py): run the renderer,
splice the collision map, geometry and georeference arguments into the
offer template, and lay out `rest/get/{offer,layout,textures}/<id>` with
base64 tile PNGs for the FlatMatch WebGL viewer; `make_rest_server` serves
such a tree with a gallery page and a WebGL walkthrough. The template and
the two pages are the JAX package's strings byte for byte, so a tree
assembled here from the same tiles is the JAX package's byte for byte.
"""
from __future__ import annotations

import base64
import json
import pathlib
import shutil
from typing import Optional

from ..config import RenderConfig
from ..render import render

# Offer skeleton: the exact contents of the reference's offer_template.json
# (a data contract, including its static demo-listing fields), so an
# assembled `rest/get/offer/<id>` is byte-identical to a reference-generated
# one. $-placeholders are spliced textually so `collisionMap` and `layout`
# keep the renderer's exact JSON bytes (generate_flatmatch_entry.py:40-51).
OFFER_TEMPLATE = """{
    "rowid": $ROW_ID,
    "landlordOfferId": "9214.025",
    "landlord": "WOBAU",
    "collisionMap": $COLLISION_MAP,
    "numRooms": 3,
    "lon": $LONGITUDE,
    "detailsUrl": "mieten_WhgDetails.asp?ObjID=41971",
    "area": 67.0,
    "layoutId": $ROW_ID,
    "level": $LEVEL,
    "lat": $LATITUDE,
    "layout": $LAYOUT,
    "hasBalcony": 1,
    "rent": 512.82,
    "scale": $SCALE,
    "address": "Apollostr. 5",
    "yaw": $YAW
}
"""


def package_offer(
    source_image: str,
    offer_id: int,
    scale: float,
    latitude: float,
    longitude: float,
    yaw: float,
    level: int,
    out_dir: str = ".",
    cfg: Optional[RenderConfig] = None,
    template: Optional[str] = None,
    device="cuda",
    checkpoint_path: Optional[str] = None,
) -> pathlib.Path:
    """Render on `device` and assemble the REST tree; returns the `rest/`
    root path. `checkpoint_path` passes to `render`. The port runs in one
    process (multi-host is not ported), so this process always writes the
    tree."""
    out = pathlib.Path(out_dir)
    tiles_dir = out / "tiles"
    if tiles_dir.exists():
        shutil.rmtree(tiles_dir)

    result = render(source_image, str(out), scale, cfg, device=device,
                    checkpoint_path=checkpoint_path)

    tpl = template if template is not None else OFFER_TEMPLATE
    tpl = tpl.replace("$COLLISION_MAP", result.collision_json)
    tpl = tpl.replace("$LONGITUDE", str(longitude))
    tpl = tpl.replace("$LATITUDE", str(latitude))
    tpl = tpl.replace("$LEVEL", str(level))
    tpl = tpl.replace("$SCALE", str(scale))
    tpl = tpl.replace("$YAW", str(yaw))
    tpl = tpl.replace("$LAYOUT", result.geometry_json)
    tpl = tpl.replace("$ROW_ID", str(offer_id))

    rest = out / "rest" / "get"
    (rest / "offer").mkdir(parents=True, exist_ok=True)
    (rest / "layout").mkdir(parents=True, exist_ok=True)
    (rest / "textures").mkdir(parents=True, exist_ok=True)

    (rest / "offer" / str(offer_id)).write_text(tpl)
    (rest / "layout" / str(offer_id)).write_bytes(
        pathlib.Path(source_image).read_bytes()
    )
    textures = {
        str(i): base64.b64encode(p.read_bytes()).decode("ascii")
        for i, p in enumerate(result.tile_paths)
    }
    (rest / "textures" / str(offer_id)).write_text(json.dumps(textures))
    return out / "rest"


# Minimal browser frontend served at "/": the functional analog of the
# reference's in-repo demo page (main.js), which appends
# each lightmap as a small <img> tile (main.js:12-17). The stale
# emscripten worker pipeline is replaced by the REST tree this server
# already publishes: the page fetches offer/layout/textures for an id and
# shows the layout, the geometry summary, and the full tile gallery.
_VIEWER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>flatmatch_tpu viewer</title>
<style>
 body { font-family: sans-serif; margin: 1.5em; background: #161616;
        color: #ddd; }
 img.tile { width: 32px; height: 32px; image-rendering: pixelated;
            margin: 1px; background: #000; }
 img.layout { border: 1px solid #555; max-width: 40em; }
 code { color: #9c9; }
</style></head><body>
<h2>flatmatch_tpu lightmap viewer</h2>
<p>offers: <span id="offers"></span></p>
<div id="view"></div>
<script>
"use strict";
async function show(id) {
  id = Number(id);  // ids are server-listed integers; coerce before any
  if (!Number.isInteger(id)) return;  // markup use (same hardening as /walk)
  const view = document.getElementById("view");
  view.innerHTML = "<h3>offer " + id + "</h3>";
  const offer = await (await fetch("rest/get/offer/" + id)).json();
  const geo = offer.layout.geometry || [];
  const p = document.createElement("p");
  p.innerHTML = "<code>" + geo.length + " rects, start ["
    + (offer.layout.startingPosition || []) + "]</code>"
    + ' &mdash; <a href="walk?id=' + id + '">walk in 3D</a>';
  view.appendChild(p);
  const img = document.createElement("img");
  img.className = "layout"; img.src = "rest/get/layout/" + id;
  view.appendChild(img);
  const tex = await (await fetch("rest/get/textures/" + id)).json();
  const gallery = document.createElement("div");
  view.appendChild(gallery);
  for (const k of Object.keys(tex)) {       // main.js:12-17 behavior
    const t = document.createElement("img");
    t.className = "tile"; t.title = "tile " + k;
    t.src = "data:image/png;base64," + tex[k];
    gallery.appendChild(t);
  }
}
(async () => {
  const ids = await (await fetch("offers")).json();
  document.getElementById("offers").innerHTML = ids.map(
    i => '<a href="#" onclick="show(' + i + ');return false">' + i + "</a>"
  ).join(" ");
  if (ids.length) show(ids[0]);
})();
</script></body></html>
"""


# WebGL first-person walkthrough: the full FlatMatch-viewer experience the
# REST tree exists to feed (README.md:35-44 "FlatMatch WebGL viewer"),
# self-contained (raw WebGL1, no dependencies). Builds two triangles per
# geometry rect (corners pos, pos+width, pos+width+height, pos+height,
# geometry.c:57-90), textures each with its rendered lightmap tile, and
# walks from startingPosition at eye height with WASD + mouse look. The
# untextured `box` rects (balcony boxes) render flat gray.
_WALK_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>flatmatch_tpu walkthrough</title>
<style>
 html,body { margin:0; height:100%; overflow:hidden; background:#000;
             font-family:sans-serif; }
 canvas { width:100%; height:100%; display:block; }
 #hud { position:fixed; top:8px; left:10px; color:#cdc; font-size:13px;
        text-shadow:0 0 3px #000; user-select:none; }
 a { color:#9c9; }
</style></head><body>
<div id="hud">loading…</div><canvas id="c"></canvas>
<script>
"use strict";
const VS = `
attribute vec3 aPos; attribute vec2 aUV;
uniform mat4 uMVP; varying vec2 vUV;
void main(){ vUV=aUV; gl_Position=uMVP*vec4(aPos,1.0); }`;
const FS = `
precision mediump float;
uniform sampler2D uTex; uniform float uFlat; varying vec2 vUV;
void main(){
  vec3 c = mix(texture2D(uTex, vUV).rgb, vec3(0.42), uFlat);
  gl_FragColor = vec4(c, 1.0);
}`;
function mat_perspective(fov, aspect, near, far){
  const f = 1/Math.tan(fov/2), nf = 1/(near-far);
  return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
          0,0,2*far*near*nf,0];
}
function mat_lookat(e, fwd, up){
  const z=[-fwd[0],-fwd[1],-fwd[2]];
  const x=norm(cross(up,z)), y=cross(z,x);
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -dot(x,e),-dot(y,e),-dot(z,e),1];
}
function mat_mul(a,b){
  const o=new Array(16);
  for(let c=0;c<4;c++)for(let r=0;r<4;r++){
    let s=0; for(let k=0;k<4;k++) s+=a[k*4+r]*b[c*4+k];
    o[c*4+r]=s;
  }
  return o;
}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
                            a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm(v){const l=Math.hypot(v[0],v[1],v[2])||1;
                 return [v[0]/l,v[1]/l,v[2]/l];}
async function main(){
  const id = new URLSearchParams(location.search).get("id")
    || (await (await fetch("offers")).json())[0];
  const offer = await (await fetch("rest/get/offer/"+id)).json();
  const tex64 = await (await fetch("rest/get/textures/"+id)).json();
  const lay = offer.layout;
  const canvas = document.getElementById("c");
  const gl = canvas.getContext("webgl");
  if (!gl) { document.getElementById("hud").textContent =
             "WebGL unavailable"; return; }
  const prog = gl.createProgram();
  for (const [t,src] of [[gl.VERTEX_SHADER,VS],[gl.FRAGMENT_SHADER,FS]]){
    const s=gl.createShader(t); gl.shaderSource(s,src); gl.compileShader(s);
    gl.attachShader(prog,s);
  }
  gl.linkProgram(prog); gl.useProgram(prog);
  const locPos=gl.getAttribLocation(prog,"aPos");
  const locUV=gl.getAttribLocation(prog,"aUV");
  const locMVP=gl.getUniformLocation(prog,"uMVP");
  const locFlat=gl.getUniformLocation(prog,"uFlat");

  // one draw batch per rect: 2 triangles, uv 0..1, its own lightmap tile
  function quad(r){
    const p=r.pos,w=r.width,h=r.height;
    const a=p, b=[p[0]+w[0],p[1]+w[1],p[2]+w[2]];
    const c=[b[0]+h[0],b[1]+h[1],b[2]+h[2]];
    const d=[p[0]+h[0],p[1]+h[1],p[2]+h[2]];
    return new Float32Array([
      a[0],a[1],a[2],0,0,  b[0],b[1],b[2],1,0,  c[0],c[1],c[2],1,1,
      a[0],a[1],a[2],0,0,  c[0],c[1],c[2],1,1,  d[0],d[1],d[2],0,1]);
  }
  const batches=[];
  for (const r of (lay.geometry||[])){
    const buf=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,buf);
    gl.bufferData(gl.ARRAY_BUFFER,quad(r),gl.STATIC_DRAW);
    const t=gl.createTexture();
    gl.bindTexture(gl.TEXTURE_2D,t);
    gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA,1,1,0,gl.RGBA,gl.UNSIGNED_BYTE,
                  new Uint8Array([80,80,80,255]));
    gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR);
    gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_S,gl.CLAMP_TO_EDGE);
    gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_T,gl.CLAMP_TO_EDGE);
    const img=new Image();
    img.onload=()=>{ gl.bindTexture(gl.TEXTURE_2D,t);
      gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA,gl.RGBA,gl.UNSIGNED_BYTE,img); };
    img.src="data:image/png;base64,"+tex64[String(r.textureId)];
    batches.push({buf,tex:t,flat:0});
  }
  for (const r of (lay.box||[])){
    const buf=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,buf);
    gl.bufferData(gl.ARRAY_BUFFER,quad(r),gl.STATIC_DRAW);
    batches.push({buf,tex:null,flat:1});
  }

  // collision: decode the RLE collisionMap (row-major over the layout
  // raster; FIRST run impassable, even indices impassable,
  // parseLayout.c:538-569) and block walking into dilated walls
  const imSize = lay.layoutImageSize || [0, 0];
  const W = imSize[0], HPix = imSize[1];
  let passable = null;
  if (offer.collisionMap && W > 0) {
    passable = new Uint8Array(W * HPix);
    let at = 0, pass = 0;               // run 0 is impassable
    for (const run of offer.collisionMap) {
      passable.fill(pass, at, at + run);
      at += run; pass = 1 - pass;
    }
  }
  const pxScale = offer.scale || 30;     // layout pixels per meter
  function canStand(x, y) {
    if (!passable) return true;
    const px = Math.floor(x * pxScale), py = Math.floor(y * pxScale);
    if (px < 0 || py < 0 || px >= W || py >= HPix) return false;
    return passable[py * W + px] === 1;
  }

  // camera: startingPosition (meters) at eye height, z-up FPS controls
  const eye=[lay.startingPosition[0], lay.startingPosition[1], 1.6];
  let yaw=0, pitch=0;
  const keys={};
  addEventListener("keydown",e=>keys[e.key.toLowerCase()]=1);
  addEventListener("keyup",e=>keys[e.key.toLowerCase()]=0);
  let drag=null;
  canvas.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY]);
  addEventListener("mouseup",()=>drag=null);
  addEventListener("mousemove",e=>{
    if(!drag) return;
    yaw -= (e.clientX-drag[0])*0.005;
    pitch = Math.max(-1.4,Math.min(1.4,pitch-(e.clientY-drag[1])*0.005));
    drag=[e.clientX,e.clientY];
  });
  // textContent (not innerHTML): `id` comes from the query string
  const hud = document.getElementById("hud");
  hud.textContent =
    "offer "+id+" — drag to look, WASD to walk, R/F up/down — ";
  const back = document.createElement("a");
  back.href = "/"; back.textContent = "gallery";
  hud.appendChild(back);

  let last=performance.now();
  function frame(now){
    const dt=Math.min(0.1,(now-last)/1000); last=now;
    const fwd=[Math.cos(pitch)*Math.cos(yaw),
               Math.cos(pitch)*Math.sin(yaw), Math.sin(pitch)];
    const right=norm(cross(fwd,[0,0,1]));
    const sp=(keys.shift?4:1.8)*dt;
    let mx=0,my=0;
    if(keys.w){mx+=fwd[0]*sp;my+=fwd[1]*sp;}
    if(keys.s){mx-=fwd[0]*sp;my-=fwd[1]*sp;}
    if(keys.d){mx+=right[0]*sp;my+=right[1]*sp;}
    if(keys.a){mx-=right[0]*sp;my-=right[1]*sp;}
    // per-axis sliding collision against the RLE map
    if(canStand(eye[0]+mx, eye[1])) eye[0]+=mx;
    if(canStand(eye[0], eye[1]+my)) eye[1]+=my;
    if(keys.r) eye[2]+=sp;
    if(keys.f) eye[2]-=sp;
    canvas.width=innerWidth; canvas.height=innerHeight;
    gl.viewport(0,0,canvas.width,canvas.height);
    gl.clearColor(0.05,0.06,0.08,1);
    gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
    gl.enable(gl.DEPTH_TEST);
    const mvp=mat_mul(
      mat_perspective(1.2, canvas.width/canvas.height, 0.05, 100),
      mat_lookat(eye,fwd,[0,0,1]));
    gl.uniformMatrix4fv(locMVP,false,new Float32Array(mvp));
    for (const b of batches){
      gl.bindBuffer(gl.ARRAY_BUFFER,b.buf);
      gl.enableVertexAttribArray(locPos);
      gl.vertexAttribPointer(locPos,3,gl.FLOAT,false,20,0);
      gl.enableVertexAttribArray(locUV);
      gl.vertexAttribPointer(locUV,2,gl.FLOAT,false,20,12);
      gl.uniform1f(locFlat,b.flat);
      if (b.tex) gl.bindTexture(gl.TEXTURE_2D,b.tex);
      gl.drawArrays(gl.TRIANGLES,0,6);
    }
    window.__walk_frames = (window.__walk_frames||0)+1;
    requestAnimationFrame(frame);
  }
  window.__walk_batches = batches.length;
  requestAnimationFrame(frame);
}
main();
</script></body></html>
"""


def make_rest_server(root: str, host: str = "127.0.0.1", port: int = 0):
    """HTTP server for an assembled REST tree (the service the reference's
    folder layout is built FOR: the FlatMatch WebGL viewer fetches
    `rest/get/{offer,layout,textures}/<id>`, generate_flatmatch_entry.py:54-82
    and the worker fetch in main.js). Also serves a built-in
    viewer page at `/` and the offer-id listing at `/offers`. Returns a
    configured `ThreadingHTTPServer`; call `.serve_forever()` (or run it
    from a thread in tests). `root` is the directory CONTAINING `rest/`."""
    import http.server

    base = pathlib.Path(root).resolve()

    class Handler(http.server.BaseHTTPRequestHandler):
        CONTENT_TYPES = {
            "offer": "application/json",
            "textures": "application/json",
            "layout": "image/png",
        }

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if not parts or parts == ["viewer"]:
                self._send(_VIEWER_HTML.encode(), "text/html; charset=utf-8")
                return
            if parts == ["walk"]:
                self._send(_WALK_HTML.encode(), "text/html; charset=utf-8")
                return
            if parts == ["offers"]:
                ids = sorted(
                    int(p.name)
                    for p in (base / "rest" / "get" / "offer").glob("*")
                    if p.name.isdigit()
                )
                self._send(json.dumps(ids).encode(), "application/json")
                return
            if (
                len(parts) != 4
                or parts[0] != "rest"
                or parts[1] != "get"
                or parts[2] not in self.CONTENT_TYPES
                or not parts[3].isdigit()  # ids are integers; no traversal
            ):
                self.send_error(404)
                return
            f = base / "rest" / "get" / parts[2] / parts[3]
            if not f.is_file():
                self.send_error(404)
                return
            self._send(f.read_bytes(), self.CONTENT_TYPES[parts[2]])

        def log_message(self, *a):  # quiet: progress goes through our tracer
            pass

    return http.server.ThreadingHTTPServer((host, port), Handler)

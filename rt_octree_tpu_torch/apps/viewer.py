"""Interactive web viewer: the GUI/web surface of the reference, on the port.

The reference ships a GLFW/ImGui desktop GUI (renderer/main.cpp) and an
Emscripten/WebGL viewer (renderer/web/main_web.cpp) whose renderers run on
the *client*.  Here the shape is inverted: rendering stays on the device
next to the octree; the browser is a thin display+input surface.  This
module serves a single-page viewer that

  * streams rendered frames as PNGs,
  * feeds mouse drags through the same Camera drag/pan/zoom state machine
    the reference GUI uses (camera.cpp:78-138 -> core/camera.py), plus
    WASD/QE keyboard navigation (main.cpp:477-560 key callback),
  * exposes the main.cpp control panel: SPP radio (1/2/4/8/16/32),
    denoise toggle (main.cpp:238-261), sigma/step thresholds, background,
    estimator, show_grid wireframe, screenshot download, the
    visualization section (render bbox, basis min/max, viewdir rotation
    -- main.cpp:287-325), the lumisphere-probe inspector (enable/xyz/
    display size -- main.cpp:401-437), and mesh manipulation: OBJ /
    drawlist-npz load by server path, per-mesh visibility, clear
    (main.cpp:439-465),
  * mirrors the web viewer's load API (main_web.cpp:276-295): load by
    server path (load_local) or by http(s) URL (load_remote) with
    extension auto-dispatch (tree / .obj / .draw.npz) and async fetch
    progress surfaced through /state (report_progress protocol).

The port's own copy of rt_octree_tpu/apps/viewer.py: the same page, HTTP
protocol and /state keys.  Frames come from the port's Renderer on
``--device`` (default cuda): kernel K1 (render_classic under the classic
estimator), K7 and K2 with denoise on, K4 on the fast rungs; a tree load
builds its LUT with K3.  Each frame is copied to the host once and encoded
by io/png.encode_png.  Every render and every change to the renderer runs
under ``ViewerState.lock``.

The busy checks of a remote load and of an export read the progress that
/state reports, which the worker sets as its last act, so a client that
has seen a load or an export end may start the next at once.

Run: python -m rt_octree_tpu_torch.apps.cli view <tree.npz> [--port 8797]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

PAGE = """<!DOCTYPE html>
<html><head><title>rt-octree-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
       display:flex; }
#img { cursor:grab; image-rendering:auto; align-self:flex-start; }
#panel { padding:12px; min-width:260px; max-height:100vh; overflow-y:auto; }
#panel label { display:block; margin:4px 0; }
#panel fieldset { border:1px solid #333; margin:8px 0; }
#fps { color:#8c8; }
input[type=number] { width:4.5em; }
</style></head><body>
<img id="img" draggable="false" tabindex="0">
<div id="panel">
  <h3>rt-octree-tpu</h3>
  <div id="fps">-</div>
  <fieldset><legend>Regular Tracking</legend>
  <label>spp:
    <select id="spp">
      <option>1</option><option>2</option><option selected>4</option>
      <option>6</option><option>8</option><option>16</option>
      <option>32</option>
    </select></label>
  <label><input type="checkbox" id="denoise"> denoise</label>
  <label>estimator:
    <select id="estimator"><option>rt</option><option>classic</option>
    </select></label>
  </fieldset>
  <fieldset><legend>Render</legend>
  <label><input type="checkbox" id="grid"> show grid</label>
  <label>bg <input id="bg" type="range" min="0" max="1" step="0.05"
                   value="1"></label>
  <label>fast (march res):
    <select id="rscale">
      <option value="1" selected>full</option>
      <option value="0.75">3/4</option>
      <option value="0.5">1/2</option>
      <option value="0.4">2/5</option>
    </select></label>
  </fieldset>
  <fieldset><legend>Visualization</legend>
  <label>bbox min <input id="bb0" type="number" step="0.05" value="0">
    <input id="bb1" type="number" step="0.05" value="0">
    <input id="bb2" type="number" step="0.05" value="0"></label>
  <label>bbox max <input id="bb3" type="number" step="0.05" value="1">
    <input id="bb4" type="number" step="0.05" value="1">
    <input id="bb5" type="number" step="0.05" value="1"></label>
  <label>basis min/max <input id="bmin" type="number" value="0">
    <input id="bmax" type="number" value="24"></label>
  <label>viewdir rot <input id="rd0" type="number" step="0.1" value="0">
    <input id="rd1" type="number" step="0.1" value="0">
    <input id="rd2" type="number" step="0.1" value="0"></label>
  </fieldset>
  <fieldset><legend>Probe</legend>
  <label><input type="checkbox" id="probe_on"> enable probe</label>
  <label>at <input id="pr0" type="number" step="0.05" value="0">
    <input id="pr1" type="number" step="0.05" value="0">
    <input id="pr2" type="number" step="0.05" value="1"></label>
  <label>size <input id="prsz" type="number" value="100"></label>
  </fieldset>
  <fieldset><legend>Tree</legend>
  <input id="treepath" placeholder="path or http(s) URL: octree .npz">
  <button onclick="loadTree()">load tree</button>
  <div id="loadprog"></div>
  </fieldset>
  <fieldset><legend>Meshes</legend>
  <input id="meshpath" placeholder="server path: .obj / drawlist .npz">
  <button onclick="loadMesh()">load</button>
  <button onclick="post({type:'clear_meshes'}).then(listMeshes)">clear
  </button>
  <div>
  <button onclick="addPrim('sphere')">sphere</button>
  <button onclick="addPrim('cube')">cube</button>
  <button onclick="addPrim('lattice')">lattice</button>
  </div>
  <div id="meshlist"></div>
  </fieldset>
  <fieldset><legend>Animation</legend>
  <label>dur <input id="akdur" type="number" step="0.1" value="1">
    <input type="checkbox" id="aksph" checked> sph
    loops <input id="akloops" type="number" value="0"></label>
  <button onclick="animAdd()">add KF at curr</button>
  <div id="kflist"></div>
  <label>scrub <input id="ascrub" type="range" min="0" max="1"
                      step="0.005" value="0" style="width:140px"></label>
  <button id="aplay" onclick="animPlay()">preview</button>
  <label>fps <input id="afps" type="number" value="30"></label>
  <label><input id="aout" placeholder="output dir (server)"></label>
  <button onclick="animRender()">render</button>
  <button onclick="post({type:'anim_stop'})">stop</button>
  <div id="aprog"></div>
  <label><input id="akpath" placeholder="keyframes .json (server)">
  </label>
  <button onclick="animIO('anim_save')">save</button>
  <button onclick="animIO('anim_load')">load</button>
  </fieldset>
  <button onclick="shot()">screenshot</button>
  <p>drag = orbit &middot; shift-drag = pan<br>wheel = zoom &middot;
     WASD/QE = move (click image first)</p>
</div>
<script>
const img = document.getElementById('img');
let seq = 0, busy = false, t0 = 0;
function refresh() {
  if (busy) return; busy = true; t0 = performance.now();
  const u = '/frame.png?seq=' + (++seq);
  fetch(u).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    document.getElementById('fps').textContent =
      (performance.now() - t0).toFixed(0) + ' ms/frame';
    busy = false;
  }).catch(() => { busy = false; });
}
function post(ev) {
  return fetch('/event', {method: 'POST', body: JSON.stringify(ev)})
    .then(r => { if (!r.ok) r.text().then(t => alert(t)); })
    .then(refresh);
}
let dragging = false;
img.addEventListener('mousedown', e => { dragging = true; img.focus();
  post({type: 'begin_drag', x: e.offsetX, y: e.offsetY,
        pan: e.shiftKey, about_origin: true}); });
window.addEventListener('mouseup', e => { if (dragging) {
  dragging = false; post({type: 'end_drag'}); } });
img.addEventListener('mousemove', e => { if (dragging)
  post({type: 'drag_update', x: e.offsetX, y: e.offsetY}); });
img.addEventListener('wheel', e => { e.preventDefault();
  post({type: 'zoom', delta: e.deltaY > 0 ? 1 : -1}); });
img.addEventListener('keydown', e => {
  if ('wasdqeWASDQE'.includes(e.key))
    post({type: 'key', key: e.key.toLowerCase(), fast: e.shiftKey});
});
function v(id) { return +document.getElementById(id).value; }
function optEvent() {
  return {type: 'options',
          spp: v('spp'),
          denoise: document.getElementById('denoise').checked,
          show_grid: document.getElementById('grid').checked,
          estimator: document.getElementById('estimator').value,
          bg: v('bg'),
          render_bbox: [v('bb0'),v('bb1'),v('bb2'),v('bb3'),v('bb4'),
                        v('bb5')],
          basis_minmax: [v('bmin'), v('bmax')],
          rot_dirs: [v('rd0'), v('rd1'), v('rd2')],
          enable_probe: document.getElementById('probe_on').checked,
          probe: [v('pr0'), v('pr1'), v('pr2')],
          probe_disp_size: v('prsz'),
          render_scale: v('rscale')};
}
for (const id of ['spp','denoise','grid','estimator','bg','rscale',
                  'bb0','bb1','bb2','bb3','bb4','bb5','bmin','bmax',
                  'rd0','rd1','rd2','probe_on','pr0','pr1','pr2',
                  'prsz']) {
  document.getElementById(id).addEventListener('change',
    () => post(optEvent()));
}
function loadMesh() {
  post({type: 'load_mesh',
        path: document.getElementById('meshpath').value})
    .then(pollLoad).then(listMeshes);
}
function loadTree() {
  post({type: 'load_tree',
        path: document.getElementById('treepath').value}).then(pollLoad);
}
function pollLoad() {
  // mirror the reference's report_progress: 0..100 fetching, 101 done
  return fetch('/state').then(r => r.json()).then(st => {
    const d = document.getElementById('loadprog');
    if (st.load_progress < 0) { d.textContent = st.load_error; return; }
    if (st.load_progress <= 100) {
      d.textContent = 'loading ' + st.load_progress.toFixed(0) + '%';
      return new Promise(res => setTimeout(res, 300)).then(pollLoad);
    }
    d.textContent = ''; refresh();
  });
}
function addPrim(kind) {
  post({type: 'add_primitive', kind: kind}).then(listMeshes);
}
function vec3Inputs(vals, step, cb) {
  const span = document.createElement('span');
  const cur = vals.slice();
  vals.forEach((x, j) => {
    const e = document.createElement('input');
    e.type = 'number'; e.step = step; e.value = x;
    e.style.width = '3.2em';
    e.addEventListener('change', () => { cur[j] = +e.value; cb(cur); });
    span.appendChild(e);
  });
  return span;
}
function listMeshes() {
  return fetch('/state').then(r => r.json()).then(st => {
    const d = document.getElementById('meshlist');
    d.innerHTML = '';
    st.meshes.forEach((m, i) => {
      const row = document.createElement('div');
      const l = document.createElement('label');
      const c = document.createElement('input');
      c.type = 'checkbox'; c.checked = m.visible;
      c.addEventListener('change', () =>
        post({type: 'mesh_edit', index: i, visible: c.checked}));
      l.appendChild(c);
      l.appendChild(document.createTextNode(' ' + m.name + ' '));
      const del = document.createElement('button');
      del.textContent = 'x';
      del.addEventListener('click', () =>
        post({type: 'mesh_del', index: i}).then(listMeshes));
      l.appendChild(del);
      row.appendChild(l);
      const tr = document.createElement('div');
      tr.appendChild(document.createTextNode('t'));
      tr.appendChild(vec3Inputs(m.translation, '0.05', v =>
        post({type: 'mesh_edit', index: i, translation: v})));
      tr.appendChild(document.createTextNode('r'));
      tr.appendChild(vec3Inputs(m.rotation, '0.1', v =>
        post({type: 'mesh_edit', index: i, rotation: v})));
      const sc = document.createElement('input');
      sc.type = 'number'; sc.step = '0.05'; sc.value = m.scale;
      sc.style.width = '3.2em';
      sc.addEventListener('change', () =>
        post({type: 'mesh_edit', index: i, scale: +sc.value}));
      tr.appendChild(document.createTextNode('s'));
      tr.appendChild(sc);
      row.appendChild(tr);
      d.appendChild(row);
    });
  });
}
function shot() { window.open('/frame.png?shot=1'); }
// ---- keyframe animation editor ----
function animAdd() {
  post({type: 'anim_add', duration: v('akdur'),
        spherical: document.getElementById('aksph').checked,
        loops: v('akloops')}).then(listKfs);
}
function listKfs() {
  return fetch('/state').then(r => r.json()).then(st => {
    const d = document.getElementById('kflist');
    d.innerHTML = '';
    st.anim.keyframes.forEach((k, i) => {
      const row = document.createElement('div');
      const dur = document.createElement('input');
      dur.type = 'number'; dur.step = '0.1'; dur.value = k.duration;
      dur.style.width = '3.5em';
      dur.addEventListener('change', () =>
        post({type: 'anim_edit', index: i, duration: +dur.value}));
      const sph = document.createElement('input');
      sph.type = 'checkbox'; sph.checked = k.spherical;
      sph.addEventListener('change', () =>
        post({type: 'anim_edit', index: i, spherical: sph.checked}));
      const mk = (txt, ev) => {
        const b = document.createElement('button');
        b.textContent = txt;
        b.addEventListener('click', () => post(ev).then(listKfs));
        return b;
      };
      row.appendChild(document.createTextNode('#' + i + ' dur'));
      row.appendChild(dur);
      row.appendChild(document.createTextNode('s sph'));
      row.appendChild(sph);
      row.appendChild(mk('goto', {type: 'anim_goto', index: i}));
      row.appendChild(mk('set', {type: 'anim_set', index: i}));
      row.appendChild(mk('spin', {type: 'anim_rotate_all', index: i}));
      row.appendChild(mk('x', {type: 'anim_del', index: i}));
      d.appendChild(row);
    });
    return st;
  });
}
document.getElementById('ascrub').addEventListener('input', () =>
  post({type: 'anim_seek', t: v('ascrub')}));
document.getElementById('afps').addEventListener('change', () =>
  post({type: 'anim_fps', fps: v('afps')}));
let playTimer = null;
function animPlay() {
  const btn = document.getElementById('aplay');
  if (playTimer) { clearInterval(playTimer); playTimer = null;
                   btn.textContent = 'preview'; return; }
  const s = document.getElementById('ascrub');
  btn.textContent = 'pause';
  playTimer = setInterval(() => {
    let t = +s.value + 0.02;
    if (t > 1) t = 0;
    s.value = t;
    post({type: 'anim_seek', t: t});
  }, 150);
}
function animRender() {
  post({type: 'anim_render',
        out_dir: document.getElementById('aout').value}).then(pollAnim);
}
function pollAnim() {
  fetch('/state').then(r => r.json()).then(st => {
    const d = document.getElementById('aprog');
    const p = st.anim.progress;
    if (p < 0) { d.textContent = st.anim.error || ''; return; }
    if (p <= 100) {
      d.textContent = 'rendering ' + p.toFixed(0) + '%';
      setTimeout(pollAnim, 500);
      return;
    }
    d.textContent = 'done';
  });
}
function animIO(type) {
  post({type: type,
        path: document.getElementById('akpath').value}).then(listKfs);
}
listKfs();
refresh();
</script></body></html>
"""


class ViewerState:
    """Owns the renderer + camera + mesh list; serializes renders behind a
    lock."""

    def __init__(self, tree_path: str, width: int = 512, height: int = 512,
                 gnet: str = "", lut_levels: int = 7, spp: int = 4,
                 device: str = "cuda"):
        import torch

        from ..core.camera import Camera
        from ..core.options import RenderOptions

        self.device = torch.device(device)
        self.lut_levels = lut_levels
        self.render_scale = 1.0  # fast mode: <1 marches at inner res
        self.cam = Camera(width=width, height=height)
        self._options = RenderOptions(spp=spp, denoise=False)
        self._gnet = gnet
        self.lock = threading.Lock()
        self.frame_count = 0
        self.meshes: list = []
        # remote-load state (main_web.cpp report_progress protocol:
        # 0..100 while fetching, 101 = finished/idle, -1 = failed)
        self.load_progress = 101.0
        self.load_error = ""
        # keyframe animation editor (main_anim.cpp:350-925 surface):
        # keyframes capture full camera+options state; preview seeks are
        # interactive events, offline export runs in a worker thread
        # with report_progress-style polling (-2 idle, 0..100 rendering,
        # 101 done, -1 failed)
        self.anim_kfs: list = []
        self.anim_fps = 30.0
        self.anim_progress = -2.0
        self.anim_error = ""
        self._anim_stop = threading.Event()
        self._set_tree(tree_path)

    def _set_tree(self, tree_path: str) -> None:
        """(Re)load an octree and rebuild the renderer around it -- the
        server-side counterpart of the web viewer's load_local/
        load_remote API (main_web.cpp:276-284; 'remote' fetching is the
        browser's concern in this inverted architecture, the server
        loads by path)."""
        from ..io import n3tree
        from ..ops.traversal import upload_tree

        self.tree_host = n3tree.load(tree_path)
        self.dt = upload_tree(self.tree_host, lut_levels=min(
            self.lut_levels, self.tree_host.max_depth), device=self.device)
        self._build_renderer()

    def _build_renderer(self) -> None:
        """(Re)build the renderer around the current tree/options/scale
        (render_scale is a constructor-level knob: it fixes the inner
        resolution K1 marches at)."""
        from ..render.renderer import Renderer

        kw = {}
        if self.render_scale != 1.0:
            kw["render_scale"] = self.render_scale
        self.renderer = Renderer(self.dt, self.cam.width, self.cam.height,
                                 self.cam.fx, self.cam.fy,
                                 options=self._options, **kw)
        if self._gnet:
            self.renderer.set_denoiser(self._gnet)
        if self._options.show_grid:
            self.renderer.set_grid_mesh(self.tree_host)

    def _apply_options(self, ev: dict) -> None:
        """Validate on a copy BEFORE mutating the live options so a bad
        value (e.g. spp=5) can't leave the shared object invalid for
        every subsequent /frame.png."""
        o = dataclasses.replace(self.renderer.options)
        if "spp" in ev:
            o.spp = int(ev["spp"])
        if "denoise" in ev:
            o.denoise = bool(ev["denoise"])
        if "estimator" in ev:
            o.estimator = str(ev["estimator"])
        if "bg" in ev:
            o.background_brightness = float(ev["bg"])
        if "show_grid" in ev:
            o.show_grid = bool(ev["show_grid"])
        if "render_bbox" in ev:
            bb = [float(x) for x in ev["render_bbox"]]
            if len(bb) != 6:
                raise ValueError("render_bbox needs 6 floats")
            o.render_bbox = tuple(bb)
        if "basis_minmax" in ev:
            mm = [int(x) for x in ev["basis_minmax"]]
            if len(mm) != 2 or mm[0] < 0 or mm[1] < mm[0]:
                raise ValueError("basis_minmax needs 0 <= min <= max")
            o.basis_minmax = tuple(mm)
        if "rot_dirs" in ev:
            rd = [float(x) for x in ev["rot_dirs"]]
            if len(rd) != 3:
                raise ValueError("rot_dirs needs 3 floats")
            o.rot_dirs = tuple(rd)
        if "enable_probe" in ev:
            o.enable_probe = bool(ev["enable_probe"])
        if "probe" in ev:
            pr = [float(x) for x in ev["probe"]]
            if len(pr) != 3:
                raise ValueError("probe needs 3 floats")
            o.probe = tuple(pr)
        if "probe_disp_size" in ev:
            sz = int(ev["probe_disp_size"])
            if not (0 < sz <= 512):
                raise ValueError("probe_disp_size must be in (0, 512]")
            o.probe_disp_size = sz
        self._set_options_obj(o)
        if "render_scale" in ev:
            rs = float(ev["render_scale"])
            if not (0.0 < rs <= 1.0):
                raise ValueError("render_scale must be in (0, 1]")
            if rs != self.render_scale:
                # constructor-level fast-mode knob: rebuild the renderer
                # around the new inner resolution (options carry over)
                self.render_scale = rs
                self._build_renderer()

    def _set_options_obj(self, o) -> None:
        """Validate + install a RenderOptions object (shared by the
        options panel and the anim editor's goto/seek)."""
        o.validate()
        if o.show_grid and self.renderer._grid_mesh is None:
            self.renderer.set_grid_mesh(self.tree_host)
        self.renderer.options = o
        self._options = o

    # ---- keyframe animation editor (main_anim.cpp:350-925) ------------
    # The reference's animator GUI: per-keyframe goto / set / duration /
    # spherical+loops / delete rows, "add KF at curr", preview seek, and
    # offline export at a chosen fps.  Persistence + interpolation live
    # in apps/anim.py; these events are the editing surface.

    def _anim_capture(self, ev: dict):
        from .anim import AnimKF
        return AnimKF.from_renderer(
            self.cam, dataclasses.replace(self._options),
            duration=float(ev.get("duration", 1.0)),
            spherical=bool(ev.get("spherical", True)),
            loops=int(ev.get("loops", 0)), meshes=self.meshes)

    def _apply_mesh_state(self, mesh_state) -> None:
        """Install keyframed per-mesh transforms, matched by name."""
        by_name = {m["name"]: m for m in mesh_state}
        for m in self.meshes:
            s = by_name.get(m.name)
            if s is None:
                continue
            m.translation = np.asarray(s["translation"], np.float32)
            m.rotation = np.asarray(s["rotation"], np.float32)
            m.scale = float(s["scale"])
            m.visible = bool(s["visible"])

    def _anim_index(self, ev: dict) -> int:
        i = int(ev.get("index", -1))
        if not (0 <= i < len(self.anim_kfs)):
            raise ValueError(f"no keyframe at index {i}")
        return i

    def _anim_apply(self, cam, options) -> None:
        """Install an interpolated/keyframed camera + options as the
        live viewer state."""
        self.cam.center = np.asarray(cam.center, np.float32).copy()
        self.cam.v_back = np.asarray(cam.v_back, np.float32).copy()
        self.cam.v_world_up = np.asarray(cam.v_world_up,
                                         np.float32).copy()
        self.cam.origin = np.asarray(cam.origin, np.float32).copy()
        self.cam.fx, self.cam.fy = float(cam.fx), float(cam.fy)
        self.cam.update()
        self.renderer.fx, self.renderer.fy = self.cam.fx, self.cam.fy
        self._set_options_obj(dataclasses.replace(options))

    def _anim_event(self, t: str, ev: dict) -> None:
        from . import anim as A
        if t == "anim_add":
            self.anim_kfs.append(self._anim_capture(ev))
        elif t == "anim_set":
            i = self._anim_index(ev)
            old = self.anim_kfs[i]
            self.anim_kfs[i] = self._anim_capture(
                {"duration": old.duration, "spherical": old.spherical,
                 "loops": old.loops})
        elif t == "anim_goto":
            k = self.anim_kfs[self._anim_index(ev)]
            opts = k.to_renderer(self.cam)  # sets camera in place
            self.renderer.fx, self.renderer.fy = self.cam.fx, self.cam.fy
            self._set_options_obj(dataclasses.replace(opts))
            self._apply_mesh_state(k.mesh_state)
        elif t == "anim_rotate_all":
            # a full extra turn for every keyframed mesh of this KF
            # (main_anim.cpp:529-533 "Rotate all")
            k = self.anim_kfs[self._anim_index(ev)]
            for s in k.mesh_state:
                s["rotation"][2] = float(s["rotation"][2]) + 2 * np.pi
        elif t == "anim_del":
            del self.anim_kfs[self._anim_index(ev)]
        elif t == "anim_edit":
            k = self.anim_kfs[self._anim_index(ev)]
            if "duration" in ev:
                d = float(ev["duration"])
                if d <= 0:
                    raise ValueError("duration must be > 0")
                k.duration = d
            if "spherical" in ev:
                k.spherical = bool(ev["spherical"])
            if "loops" in ev:
                k.loops = int(ev["loops"])
        elif t == "anim_seek":
            cam, options, ms = A.timeline_at(self.anim_kfs,
                                             float(ev.get("t", 0.0)))
            self._anim_apply(cam, options)
            self._apply_mesh_state(ms)
        elif t == "anim_fps":
            fps = float(ev.get("fps", 30.0))
            if not (0 < fps <= 240):
                raise ValueError("fps must be in (0, 240]")
            self.anim_fps = fps
        elif t == "anim_save":
            path = str(ev.get("path", ""))
            if not path:
                raise ValueError("anim_save needs a path")
            A.save_keyframes(path, self.anim_kfs, self.anim_fps)
        elif t == "anim_load":
            path = str(ev.get("path", ""))
            if not os.path.exists(path):
                raise ValueError(f"no such file: {path}")
            self.anim_kfs, self.anim_fps = A.load_keyframes(path)
        elif t == "anim_render":
            self._anim_render_start(str(ev.get("out_dir", "")))
        elif t == "anim_stop":
            self._anim_stop.set()
        else:
            raise ValueError(f"unknown event type {t!r}")

    def _anim_render_start(self, out_dir: str) -> None:
        if len(self.anim_kfs) < 2:
            raise ValueError("need at least 2 keyframes to render")
        if not out_dir:
            raise ValueError("anim_render needs out_dir")
        if 0.0 <= self.anim_progress <= 100.0:
            raise ValueError("an animation render is already in progress")
        self._anim_stop.clear()
        self.anim_progress = 0.0
        self.anim_error = ""
        kfs = list(self.anim_kfs)
        fps = self.anim_fps
        threading.Thread(target=self._anim_render_worker,
                         args=(kfs, fps, out_dir), daemon=True).start()

    def _anim_render_worker(self, kfs, fps, out_dir) -> None:
        """Offline PNG export (main_anim.cpp:1254-1262) at the viewer's
        resolution; one frame per lock acquisition so the UI stays
        responsive, stoppable between frames."""
        from ..io.png import write_png
        try:
            os.makedirs(out_dir, exist_ok=True)
            total = sum(max(int(round(k.duration * fps)), 1)
                        for k in kfs[:-1])
            from . import anim as A
            frame = 0
            for k0, k1 in zip(kfs[:-1], kfs[1:]):
                n = max(int(round(k0.duration * fps)), 1)
                for i in range(n):
                    if self._anim_stop.is_set():
                        self.anim_progress = -2.0
                        return
                    cam, options = A.interp_keyframes(k0, k1, i / n)
                    ms = A.interp_mesh_state(k0, k1, i / n)
                    with self.lock:
                        self._anim_apply(cam, options)
                        self._apply_mesh_state(ms)
                        arr = self._render_rgba_locked()
                    write_png(os.path.join(out_dir,
                                           f"{frame:06d}.png"), arr)
                    frame += 1
                    self.anim_progress = 100.0 * frame / max(total, 1)
            self.anim_progress = 101.0
        except Exception as e:  # surfaced via /state
            self.anim_error = str(e)
            self.anim_progress = -1.0

    # ---- remote loading (main_web.cpp:139-171,276-284) ----------------
    # The reference's web viewer fetches trees/OBJs/drawlists over HTTP
    # (emscripten_fetch) with progress callbacks, then hands the bytes to
    # the loader; load_remote dispatches on the URL's extension.  Here
    # the server performs the fetch asynchronously (the browser polls
    # /state.load_progress, mirroring report_progress).

    def _dispatch_load(self, path: str, kind: Optional[str]) -> None:
        """Extension dispatch of load_remote/load_local
        (main_web.cpp:276-295): .obj -> mesh, .draw.npz -> drawlist,
        anything else -> octree.  ``kind`` pins the target for the
        load_tree / load_mesh panel events."""
        if kind == "mesh" or (kind is None and (
                path.endswith(".obj") or path.endswith(".draw.npz"))):
            self._load_mesh(path)
        else:
            self._set_tree(path)

    def load_any(self, path_or_url: str, kind: Optional[str] = None
                 ) -> None:
        """Load a tree/mesh from a local path or an http(s) URL; remote
        fetches run in a background thread (caller must hold the lock)."""
        if path_or_url.startswith(("http://", "https://")):
            if 0.0 <= self.load_progress <= 100.0:
                raise ValueError("a remote load is already in progress")
            self.load_progress = 0.0
            self.load_error = ""
            threading.Thread(target=self._fetch_remote,
                             args=(path_or_url, kind), daemon=True).start()
            return
        if not os.path.exists(path_or_url):
            raise ValueError(f"no such file: {path_or_url}")
        self._dispatch_load(path_or_url, kind)

    def _fetch_remote(self, url: str, kind: Optional[str]) -> None:
        import tempfile
        import urllib.request
        tmp = None
        try:
            name = os.path.basename(url.split("?")[0]) or "remote.npz"
            with urllib.request.urlopen(url, timeout=600) as resp:
                total = int(resp.headers.get("Content-Length") or 0)
                fd, tmp = tempfile.mkstemp(suffix="_" + name)
                got = 0
                with os.fdopen(fd, "wb") as f:
                    while True:
                        chunk = resp.read(1 << 16)
                        if not chunk:
                            break
                        f.write(chunk)
                        got += len(chunk)
                        if total:
                            self.load_progress = min(
                                100.0 * got / total, 100.0)
            with self.lock:
                self._dispatch_load(tmp, kind)
            done = 101.0  # report_progress(101) = done
        except Exception as e:  # surfaced via /state, like the JS alert
            self.load_error = f"{url}: {e}"
            done = -1.0
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        # the worker's last act: a client that sees 101 or -1 may start the
        # next load at once (load_any refuses while progress is in 0..100)
        self.load_progress = done

    def handle_event(self, ev: dict) -> None:
        cam = self.cam
        t = ev.get("type")
        with self.lock:
            if t == "begin_drag":
                cam.begin_drag(ev["x"], ev["y"], bool(ev.get("pan")),
                               bool(ev.get("about_origin", True)))
            elif t == "drag_update":
                cam.drag_update(ev["x"], ev["y"])
            elif t == "end_drag":
                cam.end_drag()
            elif t == "zoom":
                # wheel zoom = move along view dir (main.cpp wheel cb)
                cam.move(np.asarray(cam.v_back, np.float32) *
                         (0.3 * float(ev.get("delta", 1))))
            elif t == "key":
                self._handle_key(str(ev.get("key", "")),
                                 bool(ev.get("fast")))
            elif t == "options":
                self._apply_options(ev)
            elif t == "load_tree":
                self.load_any(str(ev.get("path", "")), kind="tree")
            elif t == "load_mesh":
                self.load_any(str(ev.get("path", "")), kind="mesh")
            elif t == "load_remote":
                # extension auto-dispatch (main_web.cpp:276-284)
                self.load_any(str(ev.get("url", ev.get("path", ""))))
            elif t == "mesh_vis":
                i = int(ev.get("index", -1))
                if not (0 <= i < len(self.meshes)):
                    raise ValueError(f"no mesh at index {i}")
                self.meshes[i].visible = bool(ev.get("visible", True))
            elif t == "mesh_edit":
                self._mesh_edit(ev)
            elif t == "mesh_del":
                i = int(ev.get("index", -1))
                if not (0 <= i < len(self.meshes)):
                    raise ValueError(f"no mesh at index {i}")
                del self.meshes[i]
            elif t == "add_primitive":
                self._add_primitive(str(ev.get("kind", "")))
            elif t == "clear_meshes":
                self.meshes = []
            elif isinstance(t, str) and t.startswith("anim_"):
                self._anim_event(t, ev)
            else:
                raise ValueError(f"unknown event type {t!r}")

    def _handle_key(self, key: str, fast: bool) -> None:
        """WASD/QE camera movement (main.cpp:477-560: W/S along view,
        A/D strafe, Q/E world up/down; shift = 5x speed)."""
        cam = self.cam
        speed = 0.5 if fast else 0.1
        back = np.asarray(cam.v_back, np.float32)
        up = np.asarray(cam.v_world_up, np.float32)
        right = np.cross(-back, up)
        n = np.linalg.norm(right)
        right = right / n if n > 1e-9 else right
        vec = {"w": -back, "s": back, "a": -right, "d": right,
               "q": -up, "e": up}.get(key)
        if vec is None:
            raise ValueError(f"unknown key {key!r}")
        cam.move(vec * speed)

    def _load_mesh(self, path: str) -> None:
        from ..io.mesh import load_drawlist, load_obj
        if path.endswith(".npz"):
            self.meshes.extend(m for m in load_drawlist(path))
        elif path.endswith(".obj"):
            self.meshes.append(load_obj(path))
        else:
            raise ValueError("mesh path must end in .obj or .npz")

    # ---- mesh manipulation (main.cpp Manipulation panel :711-860) ------

    def _mesh_edit(self, ev: dict) -> None:
        """Per-mesh transform/flags editing (the reference edits
        translation / rotation (axis-angle) / scale / visible / unlit
        per mesh)."""
        i = int(ev.get("index", -1))
        if not (0 <= i < len(self.meshes)):
            raise ValueError(f"no mesh at index {i}")
        m = self.meshes[i]
        if "translation" in ev:
            t = [float(x) for x in ev["translation"]]
            if len(t) != 3:
                raise ValueError("translation needs 3 floats")
            m.translation = np.asarray(t, np.float32)
        if "rotation" in ev:
            r = [float(x) for x in ev["rotation"]]
            if len(r) != 3:
                raise ValueError("rotation needs 3 floats")
            m.rotation = np.asarray(r, np.float32)
        if "scale" in ev:
            m.scale = float(ev["scale"])
        if "visible" in ev:
            m.visible = bool(ev["visible"])
        if "unlit" in ev:
            m.unlit = bool(ev["unlit"])

    def _add_primitive(self, kind: str) -> None:
        """Add Sphere / Cube / Lattice primitives with the reference's
        placement defaults (sphere scale .1 / cube scale .2 at z=1;
        lattice fit over the tree volume -- main.cpp:797-837)."""
        from ..io import mesh as M
        if kind == "sphere":
            m = M.sphere()
            m.scale, m.translation = 0.1, np.array([0, 0, 1], np.float32)
        elif kind == "cube":
            m = M.cube()
            m.scale, m.translation = 0.2, np.array([0, 0, 1], np.float32)
        elif kind == "lattice":
            m = M.lattice()
            sc = np.asarray(self.tree_host.scale, np.float32).reshape(-1)
            off = np.asarray(self.tree_host.offset, np.float32)
            m.scale = float(1.0 / sc.min())
            m.translation = (-off / np.where(sc == 0, 1, sc)).astype(
                np.float32)
        else:
            raise ValueError(f"unknown primitive {kind!r}")
        n = sum(1 for x in self.meshes if x.name.startswith(m.name))
        if n:
            m.name = f"{m.name}{n}"
        self.meshes.append(m)

    def _render_rgba_locked(self) -> np.ndarray:
        """One frame (mesh raster + volume + probe) at the current
        state as uint8, copied to the host once; caller must hold
        self.lock."""
        from ..io.png import to_uint8

        kw = {}
        visible = [m for m in self.meshes if m.visible]
        if visible:
            from ..render.raster import rasterize_meshes
            bg = np.full(
                3, self.renderer.options.background_brightness,
                np.float32)
            color, depth = rasterize_meshes(visible, self.cam,
                                            background=bg)
            kw = dict(mesh_color=color, mesh_depth=depth)
        img, _ = self.renderer.render_with_probe(
            self.cam.transform, want_aux=False, **kw)
        self.renderer.advance_rng()
        return to_uint8(img.cpu().numpy())

    def render_png(self) -> bytes:
        from ..io.png import encode_png
        with self.lock:
            arr = self._render_rgba_locked()
            self.frame_count += 1
        return encode_png(arr)


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                self._send(200, state.render_png(), "image/png")
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html")
            elif self.path.startswith("/state"):
                cam = state.cam
                body = json.dumps({
                    "center": np.asarray(cam.center).tolist(),
                    "v_back": np.asarray(cam.v_back).tolist(),
                    "frames": state.frame_count,
                    "options": state.renderer.options.to_json_dict(),
                    "render_scale": state.render_scale,
                    "meshes": [{
                        "name": m.name, "visible": bool(m.visible),
                        "translation": np.asarray(
                            m.translation, np.float32).tolist(),
                        "rotation": np.asarray(
                            m.rotation, np.float32).tolist(),
                        "scale": float(m.scale),
                        "unlit": bool(m.unlit)} for m in state.meshes],
                    "load_progress": state.load_progress,
                    "load_error": state.load_error,
                    "anim": {
                        "fps": state.anim_fps,
                        "keyframes": [
                            {"duration": k.duration,
                             "spherical": bool(k.spherical),
                             "loops": int(k.loops)}
                            for k in state.anim_kfs],
                        "progress": state.anim_progress,
                        "error": state.anim_error,
                    },
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path == "/event":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    state.handle_event(ev)
                except (ValueError, KeyError, OSError) as e:
                    self._send(400, str(e).encode(), "text/plain")
                    return
                self._send(200, b"{}", "application/json")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve(state: ViewerState, port: int = 8797, poll=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"[viewer] http://127.0.0.1:{port}/  ({state.cam.width}x"
          f"{state.cam.height}, spp={state.renderer.options.spp})")
    try:
        httpd.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def run(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        "rtoctree-view", description="interactive web viewer")
    p.add_argument("file", help="octree npz")
    p.add_argument("--port", type=int, default=8797)
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--gnet", default="", help="compact .gnet denoiser")
    p.add_argument("--lut_levels", type=int, default=7)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--auto_schedule", action="store_true",
                   help="accepted for the JAX CLI's sake; the port has no "
                        "compaction schedule to tune")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)
    if args.auto_schedule:
        print("[rtoctree] --auto_schedule: the port has no compaction "
              "schedule; ignored", file=sys.stderr)
    state = ViewerState(args.file, args.width, args.height, args.gnet,
                        args.lut_levels, args.spp, device=args.device)
    serve(state, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())

"""The port's viewer, animator and tools (rt_octree_tpu_torch/apps) vs the
JAX package's, on the CPU at a small size (depth-3 and depth-4 shells, 24x24
frames, ``device="cpu"``: every wrapper takes its plain version).

Tolerances: the camera's drag machine, the tools, the keyframe format and
the interpolation are copies of NumPy code and are held bit for bit; the
animator's frames are held to the JAX Renderer's within the port's frame
bar (img 2e-5); every ``/frame.png`` decodes to exactly ``to_uint8`` of a
fresh port Renderer's frame at the viewer's state (camera, options, mesh
pass and PCG32 state).  The viewers are driven over HTTP on port 0 through
the event sequences of tests/test_apps.py's three viewer tests, the JAX
ViewerState fed the same events (it renders no frame: /state needs none),
and every wait polls /state under a deadline.  The JAX renderer takes
``schedule=((0, 1),)``: the same frame, a quarter of the compile time."""

import dataclasses
import functools
import glob
import json
import os
import re
import shutil
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from rt_octree_tpu.apps import anim as janim
from rt_octree_tpu.apps import tools as jtools
from rt_octree_tpu.apps import viewer as jviewer
from rt_octree_tpu.core import camera as jcamera
from rt_octree_tpu.core.options import RenderOptions as JOptions
from rt_octree_tpu.io import mesh as jmesh
from rt_octree_tpu.io import synthetic
from rt_octree_tpu_torch.apps import anim as tanim
from rt_octree_tpu_torch.apps import cli as tcli
from rt_octree_tpu_torch.apps import tools as ttools
from rt_octree_tpu_torch.apps import viewer as tviewer
from rt_octree_tpu_torch.core import camera as tcamera
from rt_octree_tpu_torch.core.options import RenderOptions as TOptions
from rt_octree_tpu_torch.io import mesh as tmesh
from rt_octree_tpu_torch.io import png as tpng
from rt_octree_tpu_torch.render import raster as traster
from rt_octree_tpu_torch.render import renderer as tr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYFRAMES = os.path.join(REPO, "examples", "orbit_keyframes.json")
TRANSFORMS = os.path.join(REPO, "benchmarks", "quality",
                          "transforms_test.json")
GNET = os.path.join(REPO, "benchmarks", "quality", "trained.gnet")
GT = sorted(glob.glob(os.path.join(REPO, "benchmarks", "quality", "test",
                                   "*.png")))
IMG_TOL = 2e-5
NO_COMPACTION = ((0, 1),)
W = H = 24
DEADLINE_S = 120.0


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_encode_png_roundtrips_through_read_png(tmp_path, channels):
    img = np.random.default_rng(channels).random((19, 31, channels),
                                                 np.float32)
    data = tpng.encode_png(img)
    np.testing.assert_array_equal(tpng.decode_png(data), tpng.to_uint8(img))
    (tmp_path / "x.png").write_bytes(data)
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "x.png")),
                                  tpng.to_uint8(img))


def _png_level1(img: np.ndarray) -> bytes:
    """The writer's format stated on its own: filter 0 rows, zlib level 1."""
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)) +
        chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("path", GT, ids=[os.path.basename(p) for p in GT])
def test_write_png_bytes_unchanged(tmp_path, path):
    img = tpng.read_png(path)
    out = tmp_path / "w.png"
    tpng.write_png(str(out), img)
    assert out.read_bytes() == _png_level1(img) == tpng.encode_png(img)


# ---------------------------------------------------------------------------
# camera: the drag / pan / zoom state machine
# ---------------------------------------------------------------------------

CAMERA_CASES = {
    "pan": [("begin_drag", 5, 5, True, False), ("drag_update", 15, 9),
            ("drag_update", 2, 20), ("end_drag",)],
    "pan_about_origin": [("begin_drag", 5, 5, True, True),
                         ("drag_update", 30, -4), ("end_drag",)],
    "orbit_about_origin": [("begin_drag", 5, 5, False, True),
                           ("drag_update", 15, 9), ("drag_update", 40, 2),
                           ("end_drag",), ("drag_update", 1, 1)],
    "free_orbit": [("begin_drag", 10, 3, False, False),
                   ("drag_update", -7, 12), ("drag_update", 3, -30),
                   ("end_drag",)],
    "move_during_drag": [("begin_drag", 5, 5, False, True),
                         ("drag_update", 9, 7), ("move", (0.1, -0.2, 0.3)),
                         ("drag_update", 20, 11), ("end_drag",),
                         ("move", (0.5, 0.0, 0.0))],
    # a tilt past world-up: the guard drops the update, the pose stays
    "pole_flip_guard": [("begin_drag", 0, 0, False, True),
                        ("drag_update", 0, 10), ("drag_update", 0, 30),
                        ("drag_update", 0, 5), ("end_drag",)],
}


def _cam_fields(c):
    d = c._drag
    return ([c.transform, c.center, c.v_back, c.v_right, c.v_up, c.origin,
             c.v_world_up, np.float64(c.fx), np.float64(c.fy)] +
            [np.asarray(getattr(d, f.name)) for f in
             dataclasses.fields(d) if getattr(d, f.name) is not None])


def _assert_cams_equal(got, ref):
    g, r = _cam_fields(got), _cam_fields(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CAMERA_CASES))
def test_camera_drag_bit_equal(case):
    cams = (tcamera.Camera(width=W, height=H),
            jcamera.Camera(width=W, height=H))
    before = None
    guarded = 0
    for op, *args in CAMERA_CASES[case]:
        for c in cams:
            getattr(c, op)(*args)
        _assert_cams_equal(*cams)
        if op == "drag_update" and before is not None:
            guarded += np.array_equal(before, cams[0].transform)
        before = cams[0].transform.copy()
    assert cams[0].is_dragging() is cams[1].is_dragging() is False
    if case == "pole_flip_guard":
        assert guarded >= 1  # the guard took
    else:
        assert not np.array_equal(cams[0].transform,
                                  tcamera.Camera(width=W, height=H).transform)


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------

def _rotations(kind):
    from scipy.spatial.transform import Rotation
    if kind == "random":
        return Rotation.random(16, random_state=0).as_matrix()
    axes = np.random.default_rng(3).normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([np.pi, np.pi - 1e-9, np.pi - 1e-7, np.pi - 1e-5,
                       np.pi - 1e-3])
    return Rotation.from_rotvec(axes * angles[:, None]).as_matrix()


@pytest.mark.parametrize("kind", ["random", "near_pi"])
def test_rotvec_bit_equal(kind):
    R = _rotations(kind)
    got = ttools.rotation_matrix_to_rotvec(R)
    np.testing.assert_array_equal(got, jtools.rotation_matrix_to_rotvec(R))
    if kind == "random":
        from scipy.spatial.transform import Rotation
        np.testing.assert_allclose(got, Rotation.from_matrix(R).as_rotvec(),
                                   atol=1e-6)


def _scene_root(root):
    """Two scene folders whose transforms_{test,train}.json are copies of
    the quality kit's test poses."""
    for name in ("lego", "shell"):
        os.makedirs(root / name)
        for split in ("test", "train"):
            shutil.copy(TRANSFORMS, root / name / f"transforms_{split}.json")
    return root


def _tree_files(root):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


@pytest.mark.parametrize("cmd", ["extract-test-poses",
                                 "extract-cams-drawlist"])
def test_tools_write_what_jax_writes(tmp_path, cmd):
    roots = {}
    for name, main in (("port", lambda a: tcli.main(["tools"] + a)),
                       ("jax", jtools.main)):
        roots[name] = _scene_root(tmp_path / name)
        assert main([cmd, str(roots[name])]) == 0
    files = _tree_files(roots["port"])
    assert files == _tree_files(roots["jax"])
    written = [f for f in files if not f.endswith(".json")]
    assert len(written) == (2 * 9 if cmd == "extract-test-poses" else 2)
    for f in written:
        got, ref = roots["port"] / f, roots["jax"] / f
        if f.endswith(".txt"):
            assert got.read_bytes() == ref.read_bytes(), f
            continue
        with np.load(got) as zg, np.load(ref) as zr:
            assert sorted(zg.files) == sorted(zr.files)
            for k in zg.files:
                assert zg[k].dtype == zr[k].dtype
                np.testing.assert_array_equal(zg[k], zr[k])
        meshes = tmesh.load_drawlist(str(got))
        ref_meshes = jmesh.load_drawlist(str(ref))
        assert len(meshes) == len(ref_meshes) == 1
        assert meshes[0].face_size == 2
        np.testing.assert_array_equal(meshes[0].vert, ref_meshes[0].vert)


# ---------------------------------------------------------------------------
# anim: keyframes and interpolation
# ---------------------------------------------------------------------------

MESH_STATE = [
    {"name": "cube", "translation": [0.0, 0.0, 1.0],
     "rotation": [0.0, 0.0, 0.0], "scale": 0.2, "visible": True},
    {"name": "only_k0", "translation": [1.0, 2.0, 3.0],
     "rotation": [0.1, 0.2, 0.3], "scale": 1.0, "visible": False}]
MESH_STATE_1 = [
    {"name": "cube", "translation": [1.0, -0.5, 1.0],
     "rotation": [0.0, 0.0, 2 * np.pi], "scale": 0.4, "visible": False}]
T_VALUES = (0.0, 0.1, 0.25, 0.5, 0.75, 0.999, 1.0)


def _option_fields(o):
    return {f.name: getattr(o, f.name)
            for f in dataclasses.fields(TOptions)}


def _load_both():
    (tk, tfps), (jk, jfps) = (tanim.load_keyframes(KEYFRAMES),
                              janim.load_keyframes(KEYFRAMES))
    assert tfps == jfps == 30.0
    for kfs in (tk, jk):
        kfs[0].mesh_state = [dict(m) for m in MESH_STATE]
        kfs[1].mesh_state = [dict(m) for m in MESH_STATE_1]
    return tk, jk


def _assert_interp_equal(got, ref):
    (gc, go), (rc, ro) = got[:2], ref[:2]
    _assert_cams_equal(gc, rc)
    assert _option_fields(go) == _option_fields(ro)
    if len(got) == 3:
        assert got[2] == ref[2]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_keyframes_load_across_packages(tmp_path, direction):
    writer, reader = ((janim, tanim) if direction == "jax_to_port"
                      else (tanim, janim))
    cam_mod, opt_cls, mesh_mod = (
        (jcamera, JOptions, jmesh) if writer is janim
        else (tcamera, TOptions, tmesh))
    cam = cam_mod.Camera(width=W, height=H)
    cam.begin_drag(3, 3, False, True)
    cam.drag_update(11, 7)
    cube = mesh_mod.cube()
    cube.translation = np.array([0.25, 0.0, 1.0], np.float32)
    kfs = [writer.AnimKF.from_renderer(
        cam, opt_cls(spp=2, denoise=False, estimator="classic"),
        duration=0.5, loops=1, meshes=[cube]),
        writer.AnimKF.from_renderer(cam_mod.Camera(), opt_cls(spp=8),
                                    spherical=False)]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    writer.save_keyframes(a, kfs, fps=12)
    loaded, fps = reader.load_keyframes(a)
    assert fps == 12.0
    assert [k.to_json() for k in loaded] == [k.to_json() for k in kfs]
    reader.save_keyframes(b, loaded, fps)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)


def test_sphc_interp_bit_equal():
    tk, _ = _load_both()
    c0, c1, origin = tk[0].center, tk[1].center, tk[0].origin
    for t in T_VALUES:
        for loops in (0, 1, 2):
            for a, b in ((c0, c1), (c0, c0), (c0, -c0), (origin, c1)):
                np.testing.assert_array_equal(
                    tanim.sphc_interp(a, b, origin, t, loops),
                    janim.sphc_interp(a, b, origin, t, loops))


def test_interp_keyframes_and_mesh_state_bit_equal():
    tk, jk = _load_both()
    for i in range(len(tk) - 1):
        for t in T_VALUES:
            _assert_interp_equal(tanim.interp_keyframes(tk[i], tk[i + 1], t),
                                 janim.interp_keyframes(jk[i], jk[i + 1], t))
            got = tanim.interp_mesh_state(tk[i], tk[i + 1], t)
            assert got == janim.interp_mesh_state(jk[i], jk[i + 1], t)
    assert len(tanim.interp_mesh_state(tk[0], tk[1], 0.5)) == 2


def test_timeline_at_bit_equal():
    tk, jk = _load_both()
    for frac in (-0.5, 0.0, 0.2, 0.5, 0.6, 2 / 3, 0.9, 1.0, 1.5):
        _assert_interp_equal(tanim.timeline_at(tk, frac),
                             janim.timeline_at(jk, frac))
    with pytest.raises(ValueError):
        tanim.timeline_at(tk[:1], 0.5)


def test_render_animation_frames_and_cameras(tmp_path):
    tk, jk = _load_both()
    calls = {"port": [], "jax": []}

    def factory(name):
        def f(cam, options):
            calls[name].append((cam, options))
            v = float(np.clip(cam.center[0] / 8.0 + 0.5, 0.0, 1.0))
            return np.full((H, W, 4), v, np.float32)
        return f

    n = {name: mod.render_animation(factory(name), kfs, 10.0,
                                    str(tmp_path / name), W, H)
         for name, mod, kfs in (("port", tanim, tk), ("jax", janim, jk))}
    assert n["port"] == n["jax"] == 30 == len(calls["port"])
    for got, ref in zip(calls["port"], calls["jax"]):
        _assert_interp_equal(got, ref)
        assert (got[0].width, got[0].height) == (W, H)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    import imageio.v2 as imageio
    for f in names:
        np.testing.assert_array_equal(
            tpng.read_png(str(tmp_path / "port" / f)),
            np.asarray(imageio.imread(str(tmp_path / "jax" / f))))


def test_anim_cli_frames_vs_jax_renderer(tmp_path, monkeypatch):
    """``rtoctree anim`` on the CPU (orbit_keyframes.json at 3 fps: 9
    frames) vs the JAX Renderer driven as the JAX CLI drives it."""
    from rt_octree_tpu.io import n3tree as jn3tree
    from rt_octree_tpu.ops.traversal import upload_tree as jupload
    from rt_octree_tpu.render.renderer import Renderer as JRenderer

    tree_path = str(tmp_path / "tree.npz")
    synthetic.save_npz(synthetic.make_synthetic_tree("shell", depth=4,
                                                     basis_dim=4), tree_path)
    with open(KEYFRAMES) as f:
        d = json.load(f)
    d["fps"] = 3
    kf_path = tmp_path / "kf.json"
    kf_path.write_text(json.dumps(d))

    frames = []
    real_write = tpng.write_png

    def capture(path, img):
        frames.append(np.array(img))
        real_write(path, img)
    monkeypatch.setattr(tpng, "write_png", capture)
    out = tmp_path / "out"
    assert tcli.main(["anim", tree_path, str(kf_path), "-o", str(out), "-w",
                      str(W), "--height", str(H), "--device", "cpu"]) == 0
    assert len(frames) == len(os.listdir(out)) == 9
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            tpng.read_png(str(out / f"{i:06d}.png")), tpng.to_uint8(f))

    kfs, fps = janim.load_keyframes(str(kf_path))
    jdt = jupload(jn3tree.load(tree_path))
    r = None
    i = 0
    for k0, k1 in zip(kfs[:-1], kfs[1:]):
        n = max(int(round(k0.duration * fps)), 1)
        for j in range(n):
            cam, options = janim.interp_keyframes(k0, k1, j / n)
            if r is None:
                r = JRenderer(jdt, W, H, cam.fx, cam.fy, options=options,
                              schedule=NO_COMPACTION)
            r.options = options
            r.fx, r.fy = float(cam.fx), float(cam.fy)
            ref, _ = r.render(cam.transform)
            r.advance_rng()
            ref = np.asarray(ref)
            assert frames[i].shape == ref.shape == (H, W, 4)
            assert float(ref[..., 3].max()) > 0.5  # the shell is in view
            np.testing.assert_allclose(frames[i], ref, rtol=0, atol=IMG_TOL)
            i += 1
    assert i == 9


# ---------------------------------------------------------------------------
# viewer
# ---------------------------------------------------------------------------

def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, ev):
    """-> (HTTP status, body)."""
    req = urllib.request.Request(f"{base}/event",
                                 data=json.dumps(ev).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=DEADLINE_S) as r:
        return r.read()


def _reference_frame(st, rng):
    """to_uint8 of a fresh port Renderer's frame at the viewer's state:
    its camera, options, scale, net, grid, mesh pass and PCG32 state."""
    r = tr.Renderer(st.dt, st.cam.width, st.cam.height, st.renderer.fx,
                    st.renderer.fy,
                    options=dataclasses.replace(st.renderer.options),
                    render_scale=st.render_scale)
    if st._gnet:
        r.set_denoiser(st._gnet)
    if r.options.show_grid:
        r.set_grid_mesh(st.tree_host)
    r.rng = rng
    kw = {}
    visible = [m for m in st.meshes if m.visible]
    if visible:
        color, depth = traster.rasterize_meshes(
            visible, st.cam, background=np.full(
                3, r.options.background_brightness, np.float32))
        kw = dict(mesh_color=color, mesh_depth=depth)
    img, _ = r.render_with_probe(st.cam.transform, want_aux=False, **kw)
    return tpng.to_uint8(img.numpy())


class _Viewers:
    """The port's ViewerState and the JAX package's, each behind its own
    HTTP server on port 0, fed the same events."""

    def __init__(self, tree_path, **kw):
        self.port = tviewer.ViewerState(tree_path, device="cpu", **kw)
        self.jax = jviewer.ViewerState(tree_path, **kw)
        self.servers = [_serve(tviewer.make_handler(self.port)),
                        _serve(jviewer.make_handler(self.jax))]
        self.base = self.servers[0][1]
        self.n_frames = 0
        self.anim_progress = True

    def close(self):
        for httpd, _ in self.servers:
            httpd.shutdown()
            httpd.server_close()

    def post(self, ev, code=200, jax=True, compare=True):
        """The event to both viewers (``jax=False``: to the port's only);
        both answer ``code`` with the same message, and then their /state
        agrees (unless ``compare`` is off or only the port took it)."""
        got, body = _post(self.base, ev)
        assert got == code, body
        if not jax:
            return None
        ref, ref_body = _post(self.servers[1][1], ev)
        assert ref == code, ref_body
        if code != 200:
            assert body == ref_body
        return self.state() if compare else None

    def state(self):
        """The port's /state, held to the JAX viewer's: every key but the
        frame count (the JAX viewer renders none) and, once the port has
        run an export alone, the export's progress; the camera bit for
        bit."""
        got = json.loads(_get(self.base, "/state"))
        ref = json.loads(_get(self.servers[1][1], "/state"))
        for st in (got, ref):
            st.pop("frames")
            for m in st["meshes"]:  # a fetched mesh is named by its temp file
                m["name"] = re.sub(r"^tmp\w{8}_", "", m["name"])
            if not self.anim_progress:
                st["anim"].pop("progress")
                st["anim"].pop("error")
        assert got == ref
        _assert_cams_equal(self.port.cam, self.jax.cam)
        assert ([k.to_json() for k in self.port.anim_kfs] ==
                [k.to_json() for k in self.jax.anim_kfs])
        return got

    def frame(self):
        """A /frame.png of the port's viewer, held to the reference."""
        rng = self.port.renderer.rng.copy()
        data = _get(self.base, "/frame.png")
        self.n_frames += 1
        assert data[:4] == b"\x89PNG"
        got = tpng.decode_png(data)
        assert got.shape == (H, W, 4)
        np.testing.assert_array_equal(got, _reference_frame(self.port, rng))
        return data

    def wait(self, key, jax=True, deadline=DEADLINE_S):
        """Poll the port's and (``jax``) the JAX viewer's /state until
        ``key``'s progress leaves 0..100; -> the port's state."""
        t0 = time.monotonic()
        out = []
        for base in (self.base, self.servers[1][1])[:1 + jax]:
            while True:
                st = json.loads(_get(base, "/state"))
                p = st["anim"]["progress"] if key == "anim" else st[key]
                if p > 100 or p < 0:
                    out.append(st)
                    break
                assert time.monotonic() - t0 < deadline, f"{key} timed out"
                time.sleep(0.05)
        return out[0]


def _tree(path, kind="shell", basis_dim=4):
    synthetic.save_npz(synthetic.make_synthetic_tree(kind, depth=3,
                                                     basis_dim=basis_dim),
                       str(path))
    return str(path)


def test_viewer_end_to_end(tmp_path):
    """tests/test_apps.py::test_web_viewer_end_to_end's events, with a
    denoiser, every SPP of the panel, the classic estimator, each fast
    rung, the grid, a sphere and a drawlist added."""
    v = _Viewers(_tree(tmp_path / "tree.npz"), width=W, height=H,
                 lut_levels=0, spp=1, gnet=GNET)
    try:
        assert b"rt-octree-tpu" in _get(v.base, "/")
        assert _get(v.base, "/") == _get(v.servers[1][1], "/")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v.base, "/nothing")
        assert e.value.code == 404
        png1 = v.frame()
        v.post({"type": "begin_drag", "x": 5, "y": 5, "pan": False,
                "about_origin": True})
        v.post({"type": "drag_update", "x": 15, "y": 9})
        v.post({"type": "end_drag"})
        png2 = v.frame()
        assert png2 != png1  # the orbit moved the camera
        st = v.post({"type": "options", "denoise": True, "spp": 6})
        assert st["options"]["denoise"] is True
        png_dn = v.frame()
        assert png_dn != png2
        seen = {png_dn}
        for spp in (1, 2, 4, 8, 16, 32):
            v.post({"type": "options", "spp": spp})
            seen.add(v.frame())
        assert len(seen) == 7
        st = v.post({"type": "options", "spp": 2, "denoise": False,
                     "estimator": "classic", "bg": 0.5, "show_grid": False})
        assert st["options"]["spp"] == 2
        assert st["options"]["estimator"] == "classic"
        png3 = v.frame()
        assert png3 not in seen

        # -- visualization panel: each control changes the frame --
        v.post({"type": "options", "render_bbox": [0.3, 0.3, 0.3,
                                                   0.7, 0.7, 0.7]})
        png_bbox = v.frame()
        assert png_bbox != png3
        v.post({"type": "options", "render_bbox": [0, 0, 0, 1, 1, 1],
                "basis_minmax": [0, 0]})
        png_bmm = v.frame()
        assert png_bmm != png_bbox
        v.post({"type": "options", "basis_minmax": [0, 24],
                "rot_dirs": [0.0, 0.9, 0.0]})
        png_rot = v.frame()
        assert png_rot != png_bmm
        v.post({"type": "options", "rot_dirs": [0.0, 0.0, 0.0],
                "estimator": "rt"})

        # -- the grid and the probe inspector --
        png_plain = v.frame()
        v.post({"type": "options", "show_grid": True})
        png_grid = v.frame()
        assert png_grid != png_plain
        v.post({"type": "options", "show_grid": False})
        v.post({"type": "options", "enable_probe": True,
                "probe": [0.0, 0.0, 0.5], "probe_disp_size": 8})
        png_probe = v.frame()
        assert png_probe != png_plain
        v.post({"type": "options", "enable_probe": False})

        # -- keyboard navigation and zoom --
        st2 = v.post({"type": "key", "key": "w", "fast": False})
        assert st2["center"] != st["center"]
        v.post({"type": "key", "key": "d", "fast": True})
        v.post({"type": "zoom", "delta": -1})
        v.post({"type": "key", "key": "x"}, code=400)

        # -- meshes: an OBJ in front of the volume, a sphere, a drawlist --
        obj = tmp_path / "tri.obj"
        obj.write_text("v -6 -6 2.5 1 0 0\nv 6 -6 2.5 1 0 0\n"
                       "v 0 6 2.5 1 0 0\nf 1 2 3\n")
        png_nomesh = v.frame()
        st3 = v.post({"type": "load_mesh", "path": str(obj)})
        assert len(st3["meshes"]) == 1
        png_mesh = v.frame()
        assert png_mesh != png_nomesh
        v.post({"type": "mesh_vis", "index": 0, "visible": False})
        v.post({"type": "clear_meshes"})
        v.post({"type": "add_primitive", "kind": "sphere"})
        v.post({"type": "mesh_edit", "index": 0, "scale": 2.0,
                "translation": [0.0, 0.0, 0.5]})
        png_sphere = v.frame()
        assert png_sphere != png_nomesh
        v.post({"type": "add_primitive", "kind": "lattice"})
        v.post({"type": "add_primitive", "kind": "sphere"})
        st4 = v.post({"type": "add_primitive", "kind": "cone"}, code=400)
        assert [m["name"] for m in st4["meshes"]] == [
            "Sphere", "Lattice", "Sphere1"]
        v.post({"type": "clear_meshes"})
        dl = tmp_path / "scene.draw.npz"
        np.savez_compressed(dl, box="cube", box__scale=0.6,
                            box__translation=np.array([0.0, 0.0, 0.5]))
        st5 = v.post({"type": "load_mesh", "path": str(dl)})
        assert [m["name"] for m in st5["meshes"]] == ["box"]
        assert v.frame() != png_nomesh
        v.post({"type": "mesh_del", "index": 0})
        v.post({"type": "mesh_del", "index": 0}, code=400)

        # -- tree load at run time (load_local) --
        tree2 = _tree(tmp_path / "tree2.npz", "blobs", 1)
        png_before_load = v.frame()
        v.post({"type": "load_tree", "path": tree2})
        assert v.frame() != png_before_load
        v.post({"type": "load_tree", "path": "/no/such.npz"}, code=400)

        # -- an invalid option: 400, live options untouched --
        st6 = v.post({"type": "options", "spp": 5}, code=400)
        assert st6["options"]["spp"] == 2
        v.frame()  # renderer still healthy

        # -- the fast rungs: the renderer is rebuilt around the inner size
        for rs, inner in ((0.75, 18), (0.5, 12), (0.4, 10)):
            st7 = v.post({"type": "options", "render_scale": rs})
            assert st7["render_scale"] == rs
            assert v.port.renderer.inner_width == inner
            v.frame()
        v.post({"type": "options", "render_scale": 0}, code=400)
        v.post({"type": "options", "render_scale": 1.0})
        assert v.port.renderer.inner_width == W
        v.post({"type": "bogus"}, code=400)
        st8 = json.loads(_get(v.base, "/state"))
        assert st8["frames"] == v.port.frame_count == v.n_frames
    finally:
        v.close()


def test_viewer_remote_load(tmp_path):
    """tests/test_apps.py::test_web_viewer_remote_load's events: trees and
    meshes from a local file server with extension dispatch, failures
    through /state.  A client that sees the end of a load may post the next
    at once (the JAX viewer can still refuse it while its fetch thread
    winds down, so its thread is joined first)."""
    files = tmp_path / "remote"
    files.mkdir()
    _tree(files / "tree.npz")
    _tree(files / "tree2.npz", "blobs", 1)
    (files / "tri.obj").write_text(
        "v -6 -6 2.5 1 0 0\nv 6 -6 2.5 1 0 0\nv 0 6 2.5 1 0 0\nf 1 2 3\n")
    fsrv, furl = _serve(functools.partial(SimpleHTTPRequestHandler,
                                          directory=str(files)))
    v = _Viewers(str(files / "tree.npz"), width=W, height=H, lut_levels=0,
                 spp=1)

    def load(ev):
        v.post(ev, compare=False)
        v.wait("load_progress")
        v.jax._load_thread.join(DEADLINE_S)
        assert not v.jax._load_thread.is_alive()
        return v.state()

    try:
        png0 = v.frame()
        st = load({"type": "load_remote", "url": f"{furl}/tri.obj"})
        assert st["load_progress"] == 101.0 and st["load_error"] == ""
        assert len(st["meshes"]) == 1 and st["meshes"][0]["name"]
        assert v.frame() != png0
        v.post({"type": "clear_meshes"})

        st = load({"type": "load_remote", "url": f"{furl}/tree2.npz"})
        assert st["load_progress"] == 101.0 and st["load_error"] == ""
        png_tree2 = v.frame()
        assert png_tree2 != png0

        # the load_tree panel event takes URLs too; the port takes the next
        # load as soon as its /state shows the end of this one, and refuses
        # one while a load runs
        again = {"type": "load_remote", "url": f"{furl}/tree.npz"}
        v.post({"type": "load_tree", "path": f"{furl}/tree.npz"},
               compare=False)
        assert v.wait("load_progress", jax=False)["load_progress"] == 101.0
        assert _post(v.base, again)[0] == 200
        assert v.wait("load_progress", jax=False)["load_progress"] == 101.0
        v.port.load_progress = 50.0
        assert _post(v.base, again) == (
            400, b"a remote load is already in progress")
        v.port.load_progress = 101.0
        v.wait("load_progress")
        v.jax._load_thread.join(DEADLINE_S)
        assert not v.jax._load_thread.is_alive()
        assert v.frame() == png0  # a new renderer: PCG32 from its seed

        st = load({"type": "load_remote", "url": f"{furl}/missing.npz"})
        assert st["load_progress"] == -1.0
        assert "missing.npz" in st["load_error"]
        v.frame()
    finally:
        v.close()
        fsrv.shutdown()
        fsrv.server_close()


def test_viewer_anim_editor(tmp_path):
    """tests/test_apps.py::test_web_viewer_anim_editor's events: keyframes
    from live state, seek, goto, edit, save / load, the export polled to
    its end (its first frame held to a fresh Renderer's), keyframed
    meshes, and 400 on bad events."""
    v = _Viewers(_tree(tmp_path / "tree.npz"), width=W, height=H,
                 lut_levels=0, spp=1)
    try:
        v.post({"type": "anim_add", "duration": 0.2, "spherical": True,
                "loops": 0})
        v.post({"type": "begin_drag", "x": 4, "y": 4, "pan": False,
                "about_origin": True})
        v.post({"type": "drag_update", "x": 18, "y": 10})
        v.post({"type": "end_drag"})
        st = v.post({"type": "anim_add", "duration": 0.2})
        assert len(st["anim"]["keyframes"]) == 2
        center_at_kf1 = st["center"]

        mid = v.post({"type": "anim_seek", "t": 0.5})["center"]
        assert mid != center_at_kf1
        png_mid = v.frame()
        assert v.post({"type": "anim_goto", "index": 1})["center"] == \
            center_at_kf1
        assert v.frame() != png_mid

        st = v.post({"type": "anim_edit", "index": 0, "duration": 0.3,
                     "loops": 1})
        assert st["anim"]["keyframes"][0] == {"duration": 0.3,
                                              "spherical": True, "loops": 1}
        v.post({"type": "anim_edit", "index": 0, "duration": 0.2,
                "loops": 0})
        v.post({"type": "anim_set", "index": 1})
        v.post({"type": "anim_add", "duration": 1.0})
        assert len(v.post({"type": "anim_del", "index": 2})
                   ["anim"]["keyframes"]) == 2

        paths = [str(tmp_path / "kf_port.json"), str(tmp_path / "kf_jax.json")]
        _post(v.base, {"type": "anim_fps", "fps": 10})
        _post(v.servers[1][1], {"type": "anim_fps", "fps": 10})
        for base, path in zip((v.base, v.servers[1][1]), paths):
            assert _post(base, {"type": "anim_save", "path": path})[0] == 200
        with open(paths[0]) as fp, open(paths[1]) as fj:
            assert fp.read() == fj.read()
        v.post({"type": "anim_load", "path": paths[0]})

        # the export: 0.2 s at 10 fps = 2 frames, polled to its end
        out_dir = tmp_path / "anim_out"
        rng = v.port.renderer.rng.copy()
        v.post({"type": "anim_render", "out_dir": str(out_dir)}, jax=False)
        t0 = time.monotonic()
        while True:
            st = json.loads(_get(v.base, "/state"))
            if not 0 <= st["anim"]["progress"] <= 100:
                break
            assert time.monotonic() - t0 < DEADLINE_S, "export timed out"
            time.sleep(0.05)
        assert st["anim"]["progress"] == 101.0, st["anim"]["error"]
        assert sorted(os.listdir(out_dir)) == ["000000.png", "000001.png"]
        k0, k1 = v.port.anim_kfs
        cam, options = tanim.interp_keyframes(k0, k1, 0.0)
        r = tr.Renderer(v.port.dt, W, H, cam.fx, cam.fy, options=options)
        r.rng = rng
        img, _ = r.render_with_probe(cam.transform, want_aux=False)
        np.testing.assert_array_equal(
            tpng.read_png(str(out_dir / "000000.png")),
            tpng.to_uint8(img.numpy()))
        # a client that saw the end may start the next export at once
        v.post({"type": "anim_render", "out_dir": str(out_dir)}, jax=False)
        v.post({"type": "anim_stop"}, jax=False)
        t0 = time.monotonic()
        while 0 <= json.loads(_get(v.base, "/state"))["anim"]["progress"] \
                <= 100:
            assert time.monotonic() - t0 < DEADLINE_S, "export timed out"
            time.sleep(0.05)
        # the port ran the exports alone; a seek puts both viewers at the
        # same camera and options again
        v.anim_progress = False
        v.post({"type": "anim_seek", "t": 0.0})

        # -- keyframed meshes --
        v.post({"type": "add_primitive", "kind": "cube"})
        v.post({"type": "mesh_edit", "index": 0,
                "translation": [0.0, 0.0, 1.0]})
        v.post({"type": "anim_set", "index": 0})
        v.post({"type": "mesh_edit", "index": 0,
                "translation": [1.0, 0.0, 1.0], "unlit": True})
        v.post({"type": "anim_set", "index": 1})
        v.post({"type": "anim_rotate_all", "index": 0})
        m = v.post({"type": "anim_seek", "t": 0.5})["meshes"][0]
        assert abs(m["translation"][0] - 0.5) < 1e-5
        assert abs(m["rotation"][2] - np.pi) < 1e-4
        v.frame()
        m = v.post({"type": "anim_goto", "index": 0})["meshes"][0]
        assert abs(m["translation"][0]) < 1e-6
        assert len(v.post({"type": "mesh_del", "index": 0})["meshes"]) == 0

        for bad in ({"type": "anim_goto", "index": 7},
                    {"type": "anim_edit", "index": 0, "duration": -1},
                    {"type": "anim_render", "out_dir": ""},
                    {"type": "anim_fps", "fps": 0},
                    {"type": "anim_load", "path": "/no/such.json"},
                    {"type": "anim_nope"}):
            v.post(bad, code=400)
        v.frame()  # editor errors never wedge it
    finally:
        v.close()

"""A second witness of the rare large pixels of the comparison: on the
frames of a configuration under a traffic mix, each frame's noisy image
(the march alone, before the denoiser) four ways:

- ``prog``: the program's march as the window runs it (K1, or the classic
  kernel, over the jump table with its skip distances);
- ``noskip``: the same kernel over the same tree uploaded with no skip
  distances;
- ``ref32``: the reference march, as the check runs it;
- ``ref64``: the reference march with its rays, positions and optical
  depths in float64.

    python3 perfbench/witness.py --config tanks_temples_solid \\
        --traffic orbit --seeds 1 2 --frames 100 3000 [--over 0.01]

A frame is the window's frame ``n`` of a seed's run (its pose and PCG32
frame).  One JSON line a frame: each pair's largest gap and its pixels
over ``--over``; of the pixels where ``prog`` and ``ref32`` part by more
than ``--over``, how many of them each other side matches within
``--tie``; and, where the mix denoises, the largest gap of the denoised
frame (what the check compares) of ``prog`` and of ``noskip`` to the
reference's.  Needs a card; not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this directory, whose module names (trace, ...)
# would hide the standard library's
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

PAIRS = (("prog", "ref32"), ("prog", "ref64"), ("ref32", "ref64"),
         ("noskip", "ref32"), ("noskip", "ref64"), ("prog", "noskip"))


def gaps(a, b):
    """[H, W] largest rgb gap of each pixel."""
    return (a[..., :3].float() - b[..., :3].float()).abs().amax(-1)


def frame_line(imgs: dict, over: float, tie: float) -> dict:
    out = {}
    for a, b in PAIRS:
        g = gaps(imgs[a], imgs[b])
        out[f"{a}_vs_{b}"] = [float(g.max()), int((g > over).sum())]
    far = gaps(imgs["prog"], imgs["ref32"]) > over
    out["far"] = int(far.sum())
    for a, b in (("ref64", "prog"), ("ref64", "ref32"), ("noskip", "prog"),
                 ("noskip", "ref32")):
        out[f"{a}_matches_{b}"] = int((gaps(imgs[a], imgs[b])[far]
                                       <= tie).sum())
    return out


def main(argv=None, root: str = ROOT, device=None) -> int:
    """``device``: run there without looking for a card (a test on the
    CPU)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, nargs="+", required=True)
    p.add_argument("--over", type=float, default=0.01)
    p.add_argument("--tie", type=float, default=1e-3)
    a = p.parse_args(argv)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("perfbench witness: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    from perfbench import check, scene, system, traffic
    from perfbench.reference import frame as ref_frame
    from rt_octree_tpu_torch.io import n3tree
    from rt_octree_tpu_torch.ops.traversal import upload_tree
    with open(os.path.join(root, "perfbench", "configs",
                           a.config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic",
                           a.traffic + ".json")) as f:
        mix = json.load(f)
    if float(mix["render_scale"]) != 1.0:
        print("perfbench witness: a full-size march only", file=sys.stderr)
        return 2
    dev = device
    if dev.type == "cuda":
        system.build_libraries()
    npz = scene.tree_path(cfg, root)
    net = scene.net_path(cfg, mix["net"], root) if mix["denoise"] else None
    host = n3tree.load(npz)
    trees = {k: upload_tree(host, lut_levels=int(cfg["lut_levels"]),
                            device=dev, skip_cap=cap)
             for k, cap in (("prog", int(cfg["skip_cap"])), ("noskip", 0))}
    del host
    with torch.inference_mode():
        ref = check.Reference.load(npz, net, cfg, mix, dev)
        for seed in a.seeds:
            orbit = traffic.orbit(mix, float(cfg["orbit_radius"]), seed)
            for n in a.frames:
                pose, f = orbit.pose(n), orbit.pcg32_offset + n
                imgs, final = {}, {}
                for k, t in trees.items():
                    r = system.renderer(t, cfg, mix, net, f)
                    imgs[k] = r.render_noisy(pose, want_aux=False)[0]
                    if net is not None:
                        final[k] = r.render(pose, want_aux=False)[0]
                for k, g in (("ref32", torch.float32),
                             ("ref64", torch.float64)):
                    imgs[k] = ref_frame.render(ref.tree, pose, f, ref.spec,
                                               None, None, geom=g).img
                line = {"witness": f"{a.config}.{a.traffic}", "seed": seed,
                        "n": n, **frame_line(imgs, a.over, a.tie)}
                if net is not None:
                    want = ref.render(pose, f).img
                    for k, img in final.items():
                        line[f"denoised_{k}_vs_ref32"] = float(
                            gaps(img, want).max())
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Generate OBJ meshes of spherical-harmonic lobes for visualization.

The port's copy of tools/gen_sh_mesh.py (reference:
renderer/sample_obj/sh/gen_sh.cpp, a standalone tool that writes one OBJ
per SH basis function up to a max degree; positive lobe green, negative
lobe red, radius = |Y_lm(dir)|).  NumPy on the host; it launches no
kernel.

Usage: python -m rt_octree_tpu_torch.tools.gen_sh_mesh <max_degree 0..4>
[out_dir]
"""

import os
import sys

import numpy as np

from rt_octree_tpu_torch.core.sh_np import eval_sh_basis_np


def gen_lobe_obj(basis_index: int, basis_dim: int, rings: int = 64,
                 sectors: int = 128) -> str:
    phi = np.linspace(-np.pi / 2, np.pi / 2, rings)
    theta = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    dirs = np.stack([np.cos(P) * np.cos(T), np.cos(P) * np.sin(T),
                     np.sin(P)], -1).reshape(-1, 3)
    vals = eval_sh_basis_np(basis_dim, dirs)[:, basis_index]
    radius = np.abs(vals)
    pos = dirs * radius[:, None]
    pos_color = np.where(vals[:, None] >= 0,
                         np.array([[0.2, 0.9, 0.2]]),
                         np.array([[0.9, 0.2, 0.2]]))

    lines = []
    for p, c in zip(pos, pos_color):
        lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}")
    for r in range(rings - 1):
        for s in range(sectors):
            a = r * sectors + s + 1  # OBJ is 1-indexed
            b = r * sectors + (s + 1) % sectors + 1
            lines.append(f"f {a} {b} {a + sectors}")
            lines.append(f"f {b} {b + sectors} {a + sectors}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    maxdeg = int(argv[0]) if argv else 2
    out_dir = argv[1] if len(argv) > 1 else "sh_meshes"
    os.makedirs(out_dir, exist_ok=True)
    basis_dim = (maxdeg + 1) ** 2
    for i in range(basis_dim):
        path = os.path.join(out_dir, f"sh_{i:02d}.obj")
        with open(path, "w") as f:
            f.write(gen_lobe_obj(i, basis_dim))
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

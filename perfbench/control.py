"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed one precision lower than the
configuration states (colour arithmetic in bfloat16, the net's products
from float8 e4m3), at the cell's own size.  Its numbers must fail the
cell's limits; the smallest over the seeds is each number's upper reading.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--frames 3]

Each seed draws its frames as a run's window would hold them (warm-up then
up to ``WINDOW_FRAMES`` frames) and prints one JSON line of the worst
numbers over them.  Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this directory, whose module names (trace, ...)
# would hide the standard library's
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

WINDOW_FRAMES = 20000


def readings(cell_name: str, seeds, frames: int, root: str = ROOT,
             device=None) -> list:
    """[{seed, numbers}] of the control against the reference."""
    import torch
    from perfbench import check, scene, spec, traffic
    cell = spec.cell(cell_name, root)
    cfg, mix = cell.config, cell.traffic
    if device is None:
        device = torch.device("cuda", 0)
    npz = scene.tree_path(cfg, root)
    net = scene.net_path(cfg, mix["net"], root) if mix["denoise"] else None
    out = []
    with torch.inference_mode():
        ref = check.Reference.load(npz, net, cfg, mix, device)
        for seed in seeds:
            orbit = traffic.orbit(mix, float(cfg["orbit_radius"]), seed)
            rs = random.Random(seed)
            warm = traffic.WARMUP_FRAMES
            nums = []
            for _ in range(frames):
                n = warm + rs.randrange(WINDOW_FRAMES)
                f = orbit.pcg32_offset + n
                a = ref.render(orbit.pose(n), f)
                b = ref.render(orbit.pose(n), f, low=True)
                nums.append(check.compare(b.img, a.img))
            out.append({"seed": seed, **check.worst(nums)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=None,
                   help="frames a seed (default: as many as a run checks)")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import check
    for r in readings(a.workload, a.seeds, a.frames or check.CHECK_FRAMES):
        print(json.dumps({"control": a.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

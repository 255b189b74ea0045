"""Unified CLI dispatcher: `rtoctree <command> ...`.

Commands mirror the reference's executable surface:
  render    volrend_headless equivalent (apps/headless.py)
  view      interactive web viewer (apps/viewer.py; GUI/web equivalent)
  anim      offline keyframe animation render (apps/anim.py)
  train     denoiser training/test/compact (train/main.py)
  compress  octree quantization (apps/compress.py)
  lod       depth-capped LOD tree construction (io/lod.py)
  tools     pose/drawlist extraction (apps/tools.py)
"""

from __future__ import annotations

import sys

# the JAX package's commands that the port has not ported yet: they print a
# line and run nothing (ROADMAP A.4)
NOT_PORTED = ("view", "anim", "tools")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "render":
        from .headless import run
        return run(rest)
    if cmd == "compress":
        from .compress import main as compress_main
        return compress_main(rest)
    if cmd == "train":
        from ..train.main import main as train_main
        return train_main(rest)
    if cmd == "lod":
        from ..io.lod import main as lod_main
        return lod_main(rest)
    if cmd in NOT_PORTED:
        print(f"not yet ported: {cmd}", file=sys.stderr)
        return 2
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

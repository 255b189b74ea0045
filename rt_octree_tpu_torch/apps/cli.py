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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "render":
        from .headless import run
        return run(rest)
    if cmd == "view":
        from .viewer import run as view_run
        return view_run(rest)
    if cmd == "anim":
        from .anim import main as anim_main
        return anim_main(rest) or 0
    if cmd == "train":
        from ..train.main import main as train_main
        return train_main(rest)
    if cmd == "compress":
        from .compress import main as compress_main
        return compress_main(rest)
    if cmd == "lod":
        from ..io.lod import main as lod_main
        return lod_main(rest)
    if cmd == "tools":
        from .tools import main as tools_main
        return tools_main(rest)
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

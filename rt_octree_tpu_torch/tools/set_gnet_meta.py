"""Stamp advice metadata onto an existing .gnet artifact (the port's copy
of tools/set_gnet_meta.py; the file it writes is byte for byte the JAX
tool's).

    python -m rt_octree_tpu_torch.tools.set_gnet_meta NET.gnet \\
        key=value [key=value ...]

Values parse as JSON when possible (so ``denoise_recommended=false`` is a
bool and ``fast_scale=0.5`` a number).  ``fast_scale`` names the render
scale a fast net was trained for; ``denoise_recommended`` records whether
filtering helps the scene at full size (the Renderer surfaces it and the
fast-kit teacher follows it).
"""

from __future__ import annotations

import json
import struct
import sys

MAGIC = b"GNET0001"


def set_meta(path: str, updates: dict) -> dict:
    """Merge ``updates`` into the artifact's header ``meta`` in place;
    returns the new meta."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not a .gnet artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    meta = header.get("meta", {})
    meta.update(updates)
    header["meta"] = meta
    enc = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(enc)))
        f.write(enc)
        f.write(blob)
    return meta


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("usage: set_gnet_meta NET.gnet key=value [key=value ...]",
              file=sys.stderr)
        return 2
    path, updates = argv[0], {}
    for kv in argv[1:]:
        k, _, v = kv.partition("=")
        try:
            updates[k] = json.loads(v)
        except json.JSONDecodeError:
            updates[k] = v
    meta = set_meta(path, updates)
    print(f"{path}: meta = {json.dumps(meta)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the port's CUDA kernels (nvcc, plain C ABI, ctypes).

Each source under ``rt_octree_tpu_torch/csrc`` becomes its own shared
library in ``<repo>/build/rt_octree_tpu_torch``, compiled for Hopper
(``sm_90a``) at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-source flags] -o lib<name>-<hash>.so <name>.cu

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  ``python -m
rt_octree_tpu_torch.native.build`` builds all of them and prints what
``ptxas`` reports (registers, spills).

The launch counters live here too: every kernel wrapper calls
``count_launch`` exactly where it launches its kernels, with the number of
kernels its C entry reports it launched, so a run can show that the main
path went through each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "rt_octree_tpu_torch")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# No fast math anywhere.  render.cu and lut.cu also forbid FMA contraction:
# it changes the rounding of t, the optical depth and the DDA, which can
# move a threshold crossing away from the reference march; upsample.cu
# forbids it so that its plain version rounds as it does.
SOURCES = {
    "render": ("render.cu", ["-fmad=false"]),
    "upsample": ("upsample.cu", ["-fmad=false"]),
    "filter": ("filter.cu", []),
    "lut": ("lut.cu", ["-fmad=false"]),
    "probes": ("probes.cu", []),
    "net": ("net.cu", []),
}
HEADERS = ("common.cuh",)

_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_PI, _PL = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
# C entry points: name -> (library, argtypes); every entry returns the
# cudaGetLastError() of its launches as an int.  The K3 entries launch
# several kernels and write how many through their int pointer.
ENTRIES = {
    "rt_render": ("render", [_V, _V]),
    "rt_render_params_size": ("render", []),
    "rt_upsample": ("upsample", [_V, _I, _I, _F, _F, _V, _V, _V, _I, _I, _V]),
    "rt_guided_filter": ("filter", [_V, _L, _L, _L, _V, _V, _I, _V, _I, _I,
                                    _V]),
    "rt_guided_filter_batch": ("filter", [_V] * 6 + [_I, _I, _V, _I, _I, _V]),
    "rt_guided_filter_batch_bwd": ("filter",
                                   [_V] * 8 + [_I, _I, _V, _I, _I, _V]),
    "rt_lut_build_scratch": ("lut", [_I, _I, _PL]),
    "rt_lut_build": ("lut", [_V, _V, _V, _I, _I, _I, _PI, _V]),
    "rt_skip_distances": ("lut", [_V, _V, _V, _I, _I, _PI, _V]),
    "rt_guidance_net": ("net", [_V, _L, _L, _L, _L, _I, _I, _I, _V, _V, _I,
                                _I, _V, _V, _I, _I, _V, _I, _I, _I, _I, _I,
                                _V]),
    "rt_probe_affine": ("probes", [_V, _V, _I, _V]),
    "rt_lane_gather": ("probes", [_V, _V, _V, _I, _I, _I, _V]),
    "rt_lane_gather_chain": ("probes", [_V, _V, _V, _I, _I, _I, _I, _V]),
    "rt_row_sum_ring": ("probes", [_V, _I, _V, _I, _I, _V, _V]),
    "rt_row_ring_rounds": ("probes", [_V, _I, _V, _I, _I, _I, _I, _V, _V]),
    "rt_flat_gather_chain": ("probes", [_V, _I, _V, _I, _I, _V, _V]),
}

# kernel (or K3 entry) name -> kernel launches since the last
# reset_launches()
LAUNCHES: Dict[str, int] = {
    "render": 0, "render_classic": 0, "upsample": 0, "guided_filter": 0,
    "lut_build": 0, "skip_distances": 0,
    # the training step's batched filter (K5) and its backward (K6)
    "guided_filter_batch": 0, "guided_filter_batch_bwd": 0,
    # the compact GuidanceNet (K7): one launch for a net of 1 or 2 blocks
    "guidance_net": 0,
    # the probe kernels of the measurement tools (csrc/probes.cu)
    "probe_affine": 0, "lane_gather": 0, "lane_gather_chain": 0,
    "row_sum_ring": 0, "row_ring_rounds": 0, "flat_gather_chain": 0}

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes._CFuncPtr] = {}


def count_launch(kernel: str, n: int = 1) -> None:
    LAUNCHES[kernel] += n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA toolkit required to build "
                           "the rt_octree_tpu_torch kernels)")
    return path


def _lib_path(name: str) -> str:
    src, flags = SOURCES[name]
    h = hashlib.sha1(" ".join(ARCH_FLAGS + COMMON_FLAGS + flags).encode())
    for f in (src,) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=None, verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no library for
    their current content, in parallel.  Returns name -> library path;
    raises RuntimeError with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if os.path.exists(paths[n]):
            continue
        src, flags = SOURCES[n]
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = ([nvcc_path()] + ARCH_FLAGS + COMMON_FLAGS + flags +
               (["-Xptxas=-v"] if verbose else []) +
               ["-o", tmp, os.path.join(CSRC, src)])
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[n][0]}:\n{out}")
        if verbose and out:
            print(f"[build] {SOURCES[n][0]}:\n{out.rstrip()}", file=sys.stderr)
        os.replace(tmp, paths[n])
    return paths


def entry(name: str):
    """The ctypes function of a C entry point, building and loading its
    library and binding the function at first use."""
    fn = _bound.get(name)
    if fn is None:
        lib_name, argtypes = ENTRIES[name]
        lib = _loaded.get(lib_name)
        if lib is None:
            lib = ctypes.CDLL(build([lib_name])[lib_name])
            _loaded[lib_name] = lib
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


if __name__ == "__main__":
    for k, v in build(verbose=True).items():
        print(k, v)

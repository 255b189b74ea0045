"""profile_frame.py: the device busy time is the union of the trace's
device intervals, and the script refuses to run without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import profile_frame  # noqa: E402


@pytest.mark.parametrize("intervals,expected", [
    ([], 0.0),
    ([("a", 0.0, 2.0)], 2.0),
    # overlapping and nested intervals are counted once
    ([("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0), ("d", 5.5, 5.7)],
     4.0),
    # order in the trace does not matter; touching intervals merge
    ([("c", 4.0, 5.0), ("a", 0.0, 1.0), ("b", 1.0, 2.0)], 3.0),
])
def test_busy_us_is_the_union(intervals, expected):
    assert profile_frame.busy_us(intervals) == expected


def test_device_intervals_reads_only_device_events(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 20, "dur": 1},
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 30, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 40},
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert profile_frame.device_intervals(str(path)) == [
        ("k1", 10.0, 15.0), ("cp", 20.0, 21.0), ("set", 30.0, 32.0)]


def test_profile_frame_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "profile_frame.py", "--frames",
                          "1"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0

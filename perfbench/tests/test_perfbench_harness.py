"""The harness on the CPU, on tiny cells in a copy of the benchmark: a new
cell, mix and metric found by name; the result line; the exits without a
result; and faults planted under the timed path, which must turn
``correct`` false.

    python -m pytest perfbench/tests -q
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, run, spec, witness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

from rt_octree_tpu_torch.render import renderer as R  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    tiny.make(path)
    return path


def _run(root, cell, seed=5, trace=0, seconds="0.3"):
    """(exit code, the last stdout line as a dict or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       seconds, "--trace", str(trace)], root=root,
                      device=CPU)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        if ".cache" in d or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_mix_and_metric_are_found_by_name(root):
    """A configuration, a mix, a metric reader and a limits file added as
    new files, and new entries in BENCHMARK.json: the harness runs the
    new cell and reports the new metric; no existing file changed."""
    before = _digests(root)
    with open(os.path.join(root, "perfbench", "traffic",
                           "tiny_orbit.json")) as f:
        mix = json.load(f)
    mix.update(spp=2, orbit=dict(mix["orbit"], az_step_deg=1.0))
    tiny._dump(root, "perfbench/traffic/spp2.json", mix)
    tiny._dump(root, "perfbench/limits/tiny.spp2.json",
               tiny.LIMITS["orbit"])
    with open(os.path.join(root, "perfbench", "metrics",
                           "frames_traced.py"), "w") as f:
        f.write('"""Frames in the traced window."""\n\n\n'
                "def read(rec):\n    return rec.frames\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.spp2", "config": "tiny_shell",
                               "traffic": "spp2", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "frame_ms",
                               "workloads": ["tiny.spp2"]})
    tiny._dump(root, "BENCHMARK.json", bench)
    cell = spec.cell("tiny.spp2", root)
    assert cell.traffic["spp"] == 2
    assert "frames_traced" in [m["name"] for m in cell.per_layer]
    rc, line, _ = _run(root, "tiny.spp2", trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["frames_traced"]["value"] == line["attempted"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


TRAFFIC_KEYS = {"render_scale", "estimator", "spp", "denoise", "net",
                "max_steps", "orbit", "in_flight"}


def test_mixes_hold_only_traffic():
    """A mix's file holds what its traffic is, and nothing of the run or
    the check (warm-up, checked frames, the stream's range are fixed in
    the harness, where no mix can change them)."""
    d = os.path.join(ROOT, "perfbench", "traffic")
    for name in os.listdir(d):
        with open(os.path.join(d, name)) as f:
            assert set(json.load(f)) == TRAFFIC_KEYS, name


def test_every_cell_limits_every_number():
    """Each cell of BENCHMARK.json has its limits file, naming each number
    that decides ``correct``; a file that leaves one out is refused."""
    for w in spec.load_benchmark(ROOT)["workloads"]:
        cell = spec.cell(w["name"], ROOT)
        assert set(cell.limits) == set(check.NUMBERS), w["name"]
    numbers = {k: 0.0 for k in check.NUMBERS}
    numbers["nonfinite"] = 0
    with pytest.raises(KeyError):
        check.verdict(numbers, {"mean_abs": 1.0, "p999_abs": 1.0})


@pytest.mark.parametrize("trace", (0, 1))
def test_result_line(root, trace):
    rc, line, err = _run(root, "tiny.orbit", trace=trace)
    assert rc == 0
    keys = KEYS + (["breakdown"] if trace else []) + ["card", "check"]
    assert list(line) == keys  # the compared numbers come last
    assert set(line["metrics"]) <= ({"host_ms.frame", "load_s"} if trace
                                    else {"frame_ms", "frame_p95_ms",
                                          "setup_s"})
    if not trace:
        assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms",
                                        "setup_s"}
    assert len(json.dumps(line)) < run.MAX_LINE
    # standard error ends with each compared number beside its limit
    tail = err.strip().splitlines()[-len(line["check"]) + 1:]
    assert [t.split()[1] for t in tail] == [k for k in line["check"]
                                            if k != "frames"]


def test_fit_drops_the_breakdowns_smallest_entries():
    line = {"correct": True, "metrics": {}, "breakdown": {
        "device_ops": [[f"kernel_{i}_" + "x" * 30, 1.0 / (i + 1)]
                       for i in range(10)],
        "idle_gaps": [[f"render>kernel_{i}_" + "y" * 30, 1.0 / (i + 2)]
                      for i in range(10)]}, "check": {"mean_abs": [0, 1]}}
    s = run.fit(line)
    assert len(s) <= run.MAX_LINE
    out = json.loads(s)
    assert out["breakdown"]["device_ops"][0][0].startswith("kernel_0_")
    assert list(out)[-1] == "check"


def test_no_card_no_result():
    out, err = io.StringIO(), io.StringIO()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "shell800.orbit", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


def test_jax_loaded_means_no_result(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = _run(root, "tiny.classic")
    assert rc != 0 and line is None and "jax" in err


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ only: no port."""
    tiny.make(str(tmp_path))
    code = ("import sys, torch; sys.path.insert(0, {r!r}); "
            "from perfbench import run; "
            "sys.exit(run.main(['--workload', 'tiny.orbit', '--seed', '1', "
            "'--seconds', '0.2', '--trace', '0'], root={r!r}, "
            "device=torch.device('cpu')))").format(r=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "rt_octree_tpu_torch" in p.stderr


# ---------------------------------------------------------------------------
# faults under the timed path
# ---------------------------------------------------------------------------

def _frame_repeated(monkeypatch):
    """A step that returns its state unchanged: every frame is the first
    frame again."""
    first = {}
    render = R.Renderer.render

    def stale(self, *a, **k):
        if "out" not in first:
            first["out"] = render(self, *a, **k)
        return first["out"]
    monkeypatch.setattr(R.Renderer, "render", stale)


def _rng_not_advanced(monkeypatch):
    """The per-frame stream never advances (the regular tracker only)."""
    monkeypatch.setattr(R.Renderer, "advance_rng", lambda self: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: half the
    samples a pixel (regular tracker), half the rays, the others' rows
    copied from them (classic)."""
    march = R.render_noisy

    def half(tree, transform, state, inc, *, opt, **k):
        if opt.estimator == "classic":
            img, aux, chw = march(tree, transform, state, inc, opt=opt, **k)
            img, aux = img.clone(), aux.clone()
            img[1::2], aux[1::2] = img[0:-1:2], aux[0:-1:2]
            return img, aux, chw
        return march(tree, transform, state, inc, opt=dataclasses.replace(
            opt, spp=opt.spp // 2), **k)
    monkeypatch.setattr(R, "render_noisy", half)


def _answer_altered(monkeypatch):
    """One pixel of the frame altered where it is produced."""
    render = R.Renderer.render

    def altered(self, *a, **k):
        img, aux = render(self, *a, **k)
        img = img.clone()
        img[self.height // 2, self.width // 2, 0] += 0.25
        return img, aux
    monkeypatch.setattr(R.Renderer, "render", altered)


FAULTS = {"frame_repeated": _frame_repeated,
          "rng_not_advanced": _rng_not_advanced,
          "half_batch": _half_batch, "answer_altered": _answer_altered}
CASES = [(mix, f) for mix in tiny.MIXES for f in (None, *FAULTS)
         if not (mix == "classic" and f == "rng_not_advanced")]


@pytest.mark.parametrize("mix,fault", CASES)
def test_fault_makes_the_run_incorrect(root, monkeypatch, mix, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    rc, line, _ = _run(root, f"tiny.{mix}", seed=11)
    assert rc == 0
    assert line["correct"] is (fault is None), line["check"]


def test_witness_on_a_tiny_frame(root):
    """The witness's four marches of the tiny shell's frames: the program's
    with and without skip distances and the reference's in float32 agree
    to rounding, the float64 one to a few flipped thresholds."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = witness.main(["--config", "tiny_shell", "--traffic",
                           "tiny_orbit", "--seeds", "3", "--frames", "100"],
                          root=root, device=CPU)
    assert rc == 0
    (line,) = [json.loads(x) for x in out.getvalue().splitlines()]
    assert line["prog_vs_ref32"][0] <= 1e-6 and line["far"] == 0
    assert line["noskip_vs_ref32"][0] <= 1e-6
    assert line["denoised_prog_vs_ref32"] <= tiny.LIMITS["orbit"]["max_abs"]

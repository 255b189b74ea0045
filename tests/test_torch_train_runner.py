"""The port's training stack against the JAX package's: metrics and LPIPS,
the config / dataset / logger copies on tests/test_train.py's micro-blender
fixture, the Runner end to end (train, resume, test, compact), and the
port's make_quality_dataset on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_octree_tpu.models.guidance_net import load_compact as jax_load
from rt_octree_tpu.train import config as jconfig
from rt_octree_tpu.train import dataset as jdataset
from rt_octree_tpu.train import logger as jlogger
from rt_octree_tpu.train import metrics as JM
from rt_octree_tpu_torch.train import config as tconfig
from rt_octree_tpu_torch.train import dataset as tdataset
from rt_octree_tpu_torch.train import logger as tlogger
from rt_octree_tpu_torch.train import metrics as TM
from rt_octree_tpu_torch.train.runner import Runner, find_latest_checkpoint

torch.set_num_threads(1)

H = W = 32


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_train.py's micro-blender fixture (a copy): 3 train and 2
    test frames of 32x32, noisy aux buffers and RGBA GT PNGs."""
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("blender_lego")
    rng = np.random.default_rng(0)
    for split, n in [("train", 3), ("test", 2)]:
        os.makedirs(root / split, exist_ok=True)
        os.makedirs(root / "spp_6" / split, exist_ok=True)
        frames = []
        for i in range(n):
            name = f"r_{i}"
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": np.eye(4).tolist()})
            clean = rng.random((H, W, 4)).astype(np.float32)
            clean[..., 3] = (rng.random((H, W)) > 0.3).astype(np.float32)
            noisy_rgb = np.clip(
                clean[..., :3] + 0.1 * rng.standard_normal((H, W, 3)), 0, 1)
            alpha = clean[..., 3]
            aux = np.concatenate([
                noisy_rgb.transpose(2, 0, 1), alpha[None],
                (noisy_rgb ** 2).transpose(2, 0, 1), (alpha ** 2)[None],
            ]).astype(np.float32)
            aux.tofile(root / "spp_6" / split / f"buf_{name}.bin")
            imageio.imwrite(root / split / f"{name}.png",
                            (clean * 255).astype(np.uint8))
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return str(root)


def make_argv(data_dir, work_dir, **over):
    """tests/test_train.py's make_args flags."""
    argv = ["--task", over.pop("task", "train"),
            "--data_dir", data_dir,
            "--logs_root", work_dir, "--exp_name", "t",
            "--dataset_type", "blender", "--spp", "6",
            "--nx", "2", "--ny", "2",
            "--mid_channels", "8", "--num_layers", "2",
            "--num_branches", "2", "--kernel_levels", "2",
            "--in_channels", "8",
            "--lr", "0.003", "--epochs", over.pop("epochs", "4"),
            "--batch_size", "4", "--i_save", "2", "--i_test", "100"]
    for k, v in over.items():
        argv += [f"--{k}", str(v)]
    return argv


# ---------------------------------------------------------------------------
# metrics


def _pair(seed, shape=(2, 24, 20, 3)):
    rs = np.random.default_rng(seed)
    a = rs.random(shape).astype(np.float32)
    return a, np.clip(a + 0.1 * rs.standard_normal(shape), 0, 1).astype(
        np.float32)


@pytest.mark.parametrize("name", ["smape", "mse", "huber"])
def test_losses_match_jax(name):
    """Each loss within 1e-6 of JAX's on the same images (f32 means of
    2880 terms in another order)."""
    a, b = _pair(1)
    got = TM.get_loss_fn(name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = JM.get_loss_fn(name)(jnp.asarray(a), jnp.asarray(b))
    assert abs(float(got) - float(ref)) <= 1e-6


def test_loss_names_refused_like_jax():
    for name in ("lpips_alex", "l7"):
        with pytest.raises(NotImplementedError):
            JM.get_loss_fn(name)
        with pytest.raises(NotImplementedError):
            TM.get_loss_fn(name)


def test_psnr_ssim_stdfilt_match_jax():
    """psnr and ssim (11x11 gaussian, sigma 1.5, valid) within 1e-6 of
    JAX's; stdfilt at an odd and an even window within 1e-6."""
    a, b = _pair(2)
    assert abs(TM.psnr(torch.from_numpy(a), torch.from_numpy(b))
               - JM.psnr(jnp.asarray(a), jnp.asarray(b))) <= 1e-6
    assert abs(TM.psnr(a, b) - JM.psnr(jnp.asarray(a), jnp.asarray(b))) \
        <= 1e-6  # numpy inputs, as the accumulators receive them
    got = float(TM.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(JM.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) <= 1e-6
    assert float(TM.ssim(a, a)) == pytest.approx(1.0, abs=1e-5)
    for k in (3, 4):
        np.testing.assert_allclose(
            TM.stdfilt(torch.from_numpy(a), k).numpy(),
            np.asarray(JM.stdfilt(jnp.asarray(a), k)), atol=1e-6)
    m = TM.PSNRMetric()
    m.measure(a, b)
    m.measure(b, a)
    assert m.result() == pytest.approx(TM.psnr(a, b), abs=1e-6)


CHANNELS = (64, 192, 384, 256, 256)
KSIZES = (11, 5, 3, 3, 3)


def _np_lpips(params, a, b):
    """The NumPy twin of tests/test_lpips.py (float64; a copy)."""
    strides, pads = (4, 1, 1, 1, 1), (2, 2, 1, 1, 1)
    shift = np.array([-0.030, -0.088, -0.188], np.float32)
    scale = np.array([0.458, 0.448, 0.450], np.float32)

    def conv(x, k, stride, pad):
        b_, h, w, _ = x.shape
        kh, kw, _, cout = k.shape
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        ho, wo = (h + 2 * pad - kh) // stride + 1, \
            (w + 2 * pad - kw) // stride + 1
        out = np.zeros((b_, ho, wo, cout), np.float64)
        for i in range(kh):
            for j in range(kw):
                out += xp[:, i:i + ho * stride:stride,
                          j:j + wo * stride:stride, :] @ k[i, j]
        return out

    def maxpool(x):
        ho, wo = (x.shape[1] - 3) // 2 + 1, (x.shape[2] - 3) // 2 + 1
        out = np.full((x.shape[0], ho, wo, x.shape[3]), -np.inf)
        for i in range(3):
            for j in range(3):
                out = np.maximum(out, x[:, i:i + ho * 2:2, j:j + wo * 2:2])
        return out

    def features(x):
        x = (2.0 * x.astype(np.float64) - 1.0 - shift) / scale
        feats = []
        for i in range(5):
            x = np.maximum(conv(x, params[f"conv{i}_w"].astype(np.float64),
                                strides[i], pads[i])
                           + params[f"conv{i}_b"], 0.0)
            feats.append(x)
            if i < 2:
                x = maxpool(x)
        return feats

    total = 0.0
    for i, (xa, xb) in enumerate(zip(features(a), features(b))):
        na = xa / (np.linalg.norm(xa, axis=-1, keepdims=True) + 1e-10)
        nb = xb / (np.linalg.norm(xb, axis=-1, keepdims=True) + 1e-10)
        total += np.mean(np.sum((na - nb) ** 2 * params[f"lin{i}"], -1))
    return total


def test_lpips_with_random_weights_matches_jax_and_numpy(tmp_path):
    """Random weights in the .npz contract: the port's LPIPS within 2e-4
    relative of JAX's LPIPS and of the NumPy twin (tests/test_lpips.py's
    bound), 0 for identical images, and LPIPSMetric unavailable without a
    weights file."""
    from rt_octree_tpu.train.lpips import LPIPS as JaxLPIPS
    from rt_octree_tpu_torch.train.lpips import LPIPS
    rs = np.random.default_rng(0)
    params, cin = {}, 3
    for i, (c, k) in enumerate(zip(CHANNELS, KSIZES)):
        params[f"conv{i}_w"] = (rs.standard_normal((k, k, cin, c)) /
                                (k * k * cin) ** 0.5).astype(np.float32)
        params[f"conv{i}_b"] = (rs.standard_normal(c) * 0.1).astype(
            np.float32)
        params[f"lin{i}"] = rs.random(c).astype(np.float32)
        cin = c
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **params)
    a = rs.random((2, 32, 32, 3)).astype(np.float32)
    b = rs.random((2, 32, 32, 3)).astype(np.float32)
    got = float(LPIPS(path)(a, b))
    assert got == pytest.approx(float(JaxLPIPS(path)(a, b)), rel=2e-4)
    assert got == pytest.approx(_np_lpips(params, a, b), rel=2e-4)
    assert float(LPIPS(path)(a, a.copy())) == pytest.approx(0.0, abs=1e-7)
    assert not TM.LPIPSMetric(weights_path="").available()
    m = TM.LPIPSMetric(weights_path=path)
    m.measure(torch.from_numpy(a), torch.from_numpy(b))
    assert m.available() and m.result() == pytest.approx(got, rel=1e-6)


# ---------------------------------------------------------------------------
# config, dataset, logger


def test_config_copy_matches_jax(data_dir, tmp_path):
    """The same flags, defaults and config-file parsing: every key of the
    JAX namespace equal, the port's one more key its --device."""
    cfg_file = tmp_path / "c.txt"
    cfg_file.write_text("task = train\nexp_name = foo\nlr = 0.01\nnx = 7\n"
                        "save_image = true\npreload = true\n")
    for argv in ([], ["--config", str(cfg_file)],
                 ["--config", str(cfg_file), "--lr", "0.5"],
                 make_argv(data_dir, str(tmp_path)),
                 ["--config", "configs/blender.txt"]):
        ref = vars(jconfig.parse_args(argv))
        got = vars(tconfig.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == ref
    assert tconfig.parse_args(["--device", "cpu"]).device == "cpu"


def test_dataset_copy_matches_jax(data_dir):
    """The same slices (those that pass the validity filter), the same
    batch order for each epoch's seed, and device_split on the CPU equal
    to the stacked split."""
    kw = dict(data_dir=data_dir, dataset_type="blender", spp=6, nx=2, ny=2)
    ref = jdataset.BlenderDataset(jdataset.DatasetConfig(**kw))
    got = tdataset.BlenderDataset(tdataset.DatasetConfig(**kw))
    for split in ("train", "test"):
        for field in ("aux", "img_in", "img_gt"):
            a, b = getattr(got.splits[split], field), \
                getattr(ref.splits[split], field)
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for seed in (1, 2, 3):
        for x, y in zip(got.iter_batches("train", 4, True, seed),
                        ref.iter_batches("train", 4, True, seed)):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        assert [list(i) for i in got.iter_batch_indices("train", 4, True,
                                                        seed)] == \
            [list(i) for i in ref.iter_batch_indices("train", 4, True, seed)]
    stacked = got.device_split("train", "cpu")
    for t, field in zip(stacked, ("aux", "img_in", "img_gt")):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(
            t.numpy(), np.stack(getattr(ref.splits["train"], field)))
    assert got.num_batches("train", 4) == ref.num_batches("train", 4)
    aux = np.zeros((8, 4, 4), np.float32)
    gt = np.zeros((4, 4, 4), np.uint8)
    for x, y in zip(tdataset.preprocess(aux, gt),
                    jdataset.preprocess(aux, gt)):
        np.testing.assert_array_equal(x, y)


def test_logger_copy_matches_jax(data_dir, tmp_path):
    """The same args.json (apart from --device), log lines and image dumps
    (pixels; the PNG encoders differ)."""
    from rt_octree_tpu_torch.io.png import read_png
    argv = make_argv(data_dir, str(tmp_path))
    img = np.random.default_rng(4).random((1, 8, 8, 4)).astype(np.float32)
    out = {}
    for name, cfg, lg in (("jax", jconfig, jlogger), ("port", tconfig,
                                                       tlogger)):
        args = cfg.parse_args(argv)
        logger = lg.BaseLogger(args)
        logger.log({"epoch": 1, "train/loss": 0.5})
        logger.log_image(img, str(tmp_path / name), "r", 0, {})
        with open(os.path.join(args.work_dir, "args.json")) as f:
            out[name, "args"] = json.load(f)
        with open(os.path.join(args.work_dir, "log.jsonl")) as f:
            out[name, "log"] = f.read()
        os.remove(os.path.join(args.work_dir, "log.jsonl"))
        out[name, "png"] = read_png(str(tmp_path / name / "r_0.png"))
    assert out["port", "args"].pop("device") == "cuda"
    assert out["port", "args"] == out["jax", "args"]
    assert out["port", "log"] == out["jax", "log"]
    np.testing.assert_array_equal(out["port", "png"], out["jax", "png"])


def test_wandb_logger_takes_a_stub(tmp_path):
    """WandbLogger's hook: a stub module stands in for wandb."""
    class Run:
        name = "run0"

    class Stub:
        run = Run()
        logged = []

        def init(self, project):
            self.project = project

        def log(self, d):
            self.logged.append(d)

    args = tconfig.parse_args(["--logs_root", str(tmp_path), "--exp_name",
                               "w", "--task", "train"])
    stub = Stub()
    lg = tlogger.WandbLogger(args, wandb_module=stub)
    lg.log({"epoch": 1})
    assert stub.project == "w" and args.work_dir.endswith("run0")
    assert stub.logged[-1] == {"epoch": 1}


# ---------------------------------------------------------------------------
# the Runner end to end


def _logs(work_dir):
    with open(os.path.join(work_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_runner_train_resume_test_compact(data_dir, tmp_path):
    """2 epochs on the fixture on the CPU: the loss falls, ts_000002.gnet
    (which JAX's load_compact reads) and checkpoint_000002.pt are written;
    a resume to epoch 3 continues the epoch and the lr's update count; the
    test task logs psnr and ssim and reports LPIPS unavailable; the
    compact task exports ts_latest.gnet from the latest checkpoint."""
    from rt_octree_tpu_torch.train.main import main
    argv = make_argv(data_dir, str(tmp_path), epochs="2") + \
        ["--device", "cpu", "--i_save", "1"]
    assert main(argv) == 0
    work = os.path.join(str(tmp_path), "t")
    logs = _logs(work)
    losses = [d["train/loss"] for d in logs if "train/loss" in d]
    assert len(losses) == 2 and losses[1] < losses[0], losses
    assert find_latest_checkpoint(work).endswith("checkpoint_000002.pt")
    cfg, params = jax_load(os.path.join(work, "ts_000002.gnet"))
    assert cfg.kernel_levels == 2 and cfg.mid_channels == 8
    final = logs[-1]
    assert final["test/psnr"] > 5 and 0 < final["test/ssim"] <= 1
    assert final["test/lpips"] == "unavailable (no local weights)"

    args = tconfig.parse_args(make_argv(data_dir, str(tmp_path),
                                        epochs="3")
                              + ["--device", "cpu", "--i_save", "1"])
    ds = tdataset.BlenderDataset(tdataset.DatasetConfig(
        data_dir=data_dir, dataset_type="blender", spp=6, nx=2, ny=2))
    runner = Runner(args, dataset=ds, logger=tlogger.BaseLogger(args))
    runner.train()
    spe = ds.num_batches("train", 4)
    assert runner.update_count() == 3 * spe
    epoch3 = [d for d in _logs(work) if d.get("epoch") == 3
              and "train/loss" in d]
    assert len(epoch3) == 1
    assert epoch3[0]["train/lr"] == pytest.approx(runner.lr_at_epoch(3))
    assert runner.lr_at_count(2 * spe) == pytest.approx(
        0.003 * 0.1 ** (2 / 4))

    assert main(make_argv(data_dir, str(tmp_path), task="test")
                + ["--device", "cpu"]) == 0
    last = _logs(work)[-1]
    assert set(last) == {"epoch", "test/loss", "test/psnr", "test/ssim",
                         "test/lpips"}
    assert main(make_argv(data_dir, str(tmp_path), task="compact")
                + ["--device", "cpu"]) == 0
    cfg, params = jax_load(os.path.join(work, "ts_latest.gnet"))
    folded = runner.compact(filename="")[1]
    for block in folded:
        np.testing.assert_array_equal(np.asarray(params[block]["kernel"]),
                                      folded[block]["kernel"])


def test_make_quality_dataset_on_the_cpu(tmp_path):
    """The port's make_quality_dataset on a depth-4 shell at 24x24: the
    layout the dataset reads, f32 aux buffers, the JAX tool's orbit poses
    (np.random.default_rng(7), radius 5.02; tools/make_quality_dataset.py)
    and classic-estimator GT PNGs."""
    from rt_octree_tpu.core.camera import Camera as JaxCamera
    from rt_octree_tpu_torch.io import synthetic
    from rt_octree_tpu_torch.io.png import read_png
    from rt_octree_tpu_torch.tools import make_quality_dataset as mq
    synthetic.save_npz(synthetic.make_synthetic_tree("shell", 4, 4),
                       str(tmp_path / "tree.npz"))
    out = tmp_path / "kit"
    assert mq.main(["--out", str(out), "--tree", str(tmp_path / "tree.npz"),
                    "--n_train", "2", "--n_test", "2", "--res", "24",
                    "--device", "cpu"]) == 0
    rng = np.random.default_rng(7)
    for split in ("train", "test"):
        with open(out / f"transforms_{split}.json") as f:
            meta = json.load(f)
        for i, frame in enumerate(meta["frames"]):
            azim = rng.uniform(0, 2 * np.pi)
            elev = rng.uniform(np.deg2rad(-25), np.deg2rad(65))
            c = 5.02 * np.array([np.cos(elev) * np.cos(azim),
                                 np.cos(elev) * np.sin(azim),
                                 np.sin(elev)], np.float32)
            cam = JaxCamera(width=24, height=24, center=c,
                            v_back=c / np.linalg.norm(c))
            np.testing.assert_array_equal(
                np.asarray(frame["transform_matrix"], np.float32)[:3],
                cam.transform)
            assert frame["file_path"] == f"./{split}/r_{i}"
            aux = np.fromfile(out / "spp_6" / split / f"buf_r_{i}.bin",
                              np.float32)
            assert aux.size == 8 * 24 * 24 and np.isfinite(aux).all()
            assert read_png(str(out / split / f"r_{i}.png")).shape == \
                (24, 24, 3)
    ds = tdataset.BlenderDataset(tdataset.DatasetConfig(
        data_dir=str(out), dataset_type="blender", spp=6, nx=2, ny=2))
    assert len(ds.splits["test"].aux) == 2

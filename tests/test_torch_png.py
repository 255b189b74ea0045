"""The port's zlib+numpy PNG reader/writer vs imageio."""

import glob
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from rt_octree_tpu.io.images import to_uint8 as jax_to_uint8
from rt_octree_tpu_torch.io.png import read_png, to_uint8, write_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GT = sorted(glob.glob(os.path.join(REPO, "benchmarks", "quality", "test",
                                   "*.png")))


def test_every_gt_png_is_found():
    assert len(GT) == 8


@pytest.mark.parametrize("path", GT, ids=[os.path.basename(p) for p in GT])
def test_reader_equals_imageio_on_gt(path):
    got = read_png(path)
    ref = np.asarray(imageio.imread(path))
    assert got.shape == ref.shape == (800, 800, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [3, 4])
def test_writer_roundtrip_via_imageio(tmp_path, channels):
    rs = np.random.default_rng(channels)
    img = rs.random((17, 23, channels), np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    ref = to_uint8(img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), ref)
    np.testing.assert_array_equal(read_png(path), ref)


def test_to_uint8_matches_jax_package():
    x = np.linspace(-0.5, 1.5, 1001, dtype=np.float32)
    np.testing.assert_array_equal(to_uint8(x), jax_to_uint8(x))


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """Encode with the given per-row filter types (PNG spec, section 9)."""
    h, w, c = img.shape
    raw = bytearray()
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - left
        elif f == 2:
            enc = row - prior
        elif f == 3:
            enc = row - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            enc = row - pred
        raw += bytes([f]) + bytes((enc & 0xFF).astype(np.uint8))
        prior = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ct = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_reader_handles_every_row_filter(tmp_path, channels):
    rs = np.random.default_rng(10 + channels)
    img = rs.integers(0, 256, (10, 7, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(str(path)), img)
    np.testing.assert_array_equal(
        np.asarray(imageio.imread(str(path))).reshape(img.shape), img)


def test_reader_refuses_other_pngs(tmp_path):
    path = tmp_path / "bad.png"
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(path))

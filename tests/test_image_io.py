"""The numpy + zlib PNG codec (utils/image_io.py) against Pillow.

Pillow is a test-only reference here: the render path itself never imports
it. Every PNG shipped under tests/scenes must decode exactly as Pillow
decodes it, the encoder must round-trip, and each of the five row filters
must undo exactly.
"""
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from path_tracer_tpu.utils import image_io

SCENE_PNGS = sorted((Path(__file__).parent / "scenes").rglob("*.png"))


def _pil():
    return pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("path", SCENE_PNGS,
                         ids=[p.parent.name + "/" + p.name for p in SCENE_PNGS])
def test_scene_pngs_decode_like_pillow(path):
    Image = _pil()
    px, mode = image_io.read_png(path)
    ref = Image.open(path)
    np.testing.assert_array_equal(image_io.to_rgba(px, mode),
                                  np.asarray(ref.convert("RGBA")))
    np.testing.assert_array_equal(
        image_io.load_texture_rgb(path),
        np.asarray(ref.convert("RGB"), np.float32) / 255.0)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_round_trip(channels):
    Image = _pil()
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = image_io.encode_png(img)
    px, mode = image_io.decode_png(data)
    assert mode == {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    np.testing.assert_array_equal(px.reshape(img.shape), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape), img)


def _pillow_png(kind):
    Image = _pil()
    yy, xx = np.mgrid[0:61, 0:83]
    buf = io.BytesIO()
    if kind == "rgb_smooth":  # Pillow picks per-row filters, Paeth among them
        img = np.stack([xx % 256, (yy * 3) % 256, (xx + yy) // 2 % 256], -1)
        Image.fromarray(img.astype(np.uint8), "RGB").save(buf, "PNG",
                                                          optimize=True)
    elif kind == "gray_alpha":
        img = np.stack([(xx * 3) % 256, (yy * 4) % 256], -1).astype(np.uint8)
        Image.fromarray(img, "LA").save(buf, "PNG")
    elif kind == "palette_trns_4bit":
        p = Image.fromarray((xx % 16).astype(np.uint8), "P")
        p.putpalette([int(v) for v in np.arange(48) * 5])
        p.save(buf, "PNG", bits=4, transparency=bytes(range(0, 256, 16)))
    elif kind == "palette_8bit":
        p = Image.fromarray(((xx + yy) % 200).astype(np.uint8), "P")
        p.putpalette([int(v) % 256 for v in np.arange(768) * 7])
        p.save(buf, "PNG")
    else:  # 1-bit gray
        g = Image.fromarray((((xx // 3 + yy) % 2) * 255).astype(np.uint8))
        g.convert("1").save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["rgb_smooth", "gray_alpha",
                                  "palette_trns_4bit", "palette_8bit",
                                  "gray_1bit"])
def test_pillow_written_pngs_decode(kind):
    Image = _pil()
    data = _pillow_png(kind)
    px, mode = image_io.decode_png(data)
    np.testing.assert_array_equal(
        image_io.to_rgba(px, mode),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


def _filtered_png(img, ftype):
    """Encode an RGB image with one PNG filter type on every row (a plain
    per-byte implementation of the spec, independent of the codec)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(w * c, np.int32)
        out.append(ftype)
        for x in range(w * c):
            a = rows[y, x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((int(rows[y, x]) - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_each_row_filter_undoes_exactly(ftype):
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    px, mode = image_io.decode_png(_filtered_png(img, ftype))
    assert mode == "RGB"
    np.testing.assert_array_equal(px, img)


def test_gray_load_uses_rec709_luma(tmp_path):
    rgb = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255], [10, 200, 90]]],
                   np.uint8)
    image_io.save_png(rgb, tmp_path / "c.png")
    got = image_io.load_texture_gray(tmp_path / "c.png") * 255.0
    luma = rgb.astype(np.float32) @ np.array([0.2126, 0.7152, 0.0722],
                                             np.float32)
    np.testing.assert_allclose(got[0], np.floor(luma[0] + 0.5), atol=1e-4)


@pytest.mark.parametrize("what", ["16-bit", "interlaced"])
def test_unsupported_pngs_raise(what):
    depth, interlace = (16, 0) if what == "16-bit" else (8, 1)
    ihdr = struct.pack(">IIBBBBB", 2, 2, depth, 0, 0, 0, interlace)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(16))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="not supported|unsupported"):
        image_io.decode_png(data)

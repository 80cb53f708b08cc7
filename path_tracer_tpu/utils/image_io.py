"""PNG texture/image IO, in numpy + zlib.

Replaces the reference's `image` crate usage (ref: texture_bank.rs:26-33 for
decode, main.rs:50 for encode). Gray conversion of non-gray PNGs uses the
Rec.709 luma the Rust image crate uses for into_luma8 (0.2126/0.7152/0.0722) —
NOT Rec.601 — so opacity/metalness/roughness textures stored as RGB decode
identically.

The codec covers non-interlaced PNGs of 8-bit gray, gray+alpha, RGB and RGBA,
and palette images (1/2/4/8-bit, with tRNS alpha), with all five row
filters. Anything else (16-bit samples, Adam7 interlacing) raises
``ValueError`` naming what is unsupported.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel (0 gray, 2 RGB, 3 palette, 4 gray+alpha,
# 6 RGBA).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row filters. raw: filter byte + row_bytes per row.
    Returns [height, row_bytes] uint8."""
    rows = raw.reshape(height, row_bytes + 1)
    ftype = rows[:, 0]
    filt = rows[:, 1:].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((height, row_bytes), np.int32)
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up only: row by row, Sub as a running sum per channel.
        prev = np.zeros(row_bytes, np.int32)
        for y in range(height):
            row = filt[y]
            if ftype[y] == 1:
                pad = (-row_bytes) % bpp
                cols = np.concatenate([row, np.zeros(pad, np.int32)])
                row = np.cumsum(cols.reshape(-1, bpp), axis=0).reshape(-1)
                row = row[:row_bytes]
            elif ftype[y] == 2:
                row = row + prev
            prev = row & 0xFF
            out[y] = prev
        return out.astype(np.uint8)
    # Average / Paeth depend on the left, upper and upper-left pixel, so
    # pixels on one anti-diagonal (x + y = const) are independent: decode
    # diagonal by diagonal, every filter type at once.
    w = -(-row_bytes // bpp)
    fp = np.zeros((height, w * bpp), np.int32)
    fp[:, :row_bytes] = filt
    fp = fp.reshape(height, w, bpp)
    dec = np.zeros((height + 1, w + 1, bpp), np.int32)  # zero border
    for dg in range(height + w - 1):
        y = np.arange(max(0, dg - w + 1), min(height - 1, dg) + 1)
        x = dg - y
        a = dec[y + 1, x]
        b = dec[y, x + 1]
        c = dec[y, x]
        t = ftype[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        dec[y + 1, x + 1] = (fp[y, x] + pred) & 0xFF
    return dec[1:, 1:].reshape(height, w * bpp)[:, :row_bytes].astype(
        np.uint8)


def decode_png(data: bytes) -> tuple[np.ndarray, str]:
    """PNG bytes -> (pixels [H,W,C] uint8, mode), mode one of "L", "LA",
    "RGB", "RGBA". Palette images expand to RGB, or RGBA when they carry
    tRNS alpha; a gray/RGB tRNS color key becomes an alpha channel."""
    header = None
    palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG color type {ctype}")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"unsupported PNG bit depth {depth} "
                         f"(color type {ctype})")
    nch = _CHANNELS[ctype]
    row_bytes = -(-width * nch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError("truncated PNG image data")
    rows = _unfilter(raw[: height * (row_bytes + 1)], height, row_bytes,
                     max(1, nch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :width]
        if ctype == 0:  # scale gray samples to 0..255
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(
                np.uint8)
        px = px[..., None]
    else:
        px = rows.reshape(height, width, nch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0]
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        if trns is None:
            return rgb, "RGB"
        alpha = np.full(256, 255, np.uint8)
        alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1), "RGBA"
    if trns is not None and ctype in (0, 2):
        key = np.frombuffer(trns, ">u2").astype(np.int32)
        alpha = np.where((px.astype(np.int32) == key).all(axis=-1), 0, 255)
        px = np.concatenate([px, alpha.astype(np.uint8)[..., None]], axis=-1)
        return px, "LA" if ctype == 0 else "RGBA"
    return px, {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[ctype]


def encode_png(pixels: np.ndarray) -> bytes:
    """[H,W] (gray), [H,W,3] (RGB) or [H,W,4] (RGBA) uint8 -> PNG bytes
    (8-bit, non-interlaced, Up filter on every row)."""
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    height, width, nch = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    rows = px.reshape(height, width * nch)
    up = rows.astype(np.int16)
    up[1:] -= rows[:-1]
    filtered = np.empty((height, width * nch + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[:, 1:] = (up & 0xFF).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path) -> tuple[np.ndarray, str]:
    return decode_png(Path(path).read_bytes())


def to_rgba(pixels: np.ndarray, mode: str) -> np.ndarray:
    """Decoded pixels -> [H,W,4] uint8 (gray replicates, alpha 255)."""
    if mode == "RGBA":
        return pixels
    if mode == "RGB":
        rgb, alpha = pixels, None
    else:
        rgb = np.repeat(pixels[..., :1], 3, axis=-1)
        alpha = pixels[..., 1] if mode == "LA" else None
    if alpha is None:
        alpha = np.full(pixels.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def load_texture_rgb(path) -> np.ndarray:
    """Load a PNG as [H,W,3] float32 in [0,1] (raw values, no sRGB decode —
    linearization is a sample-time decision, ref material.rs:137-141)."""
    px, mode = read_png(path)
    return to_rgba(px, mode)[..., :3].astype(np.float32) / 255.0


def load_texture_gray(path) -> np.ndarray:
    """Load a PNG as [H,W] float32 in [0,1].

    Gray PNGs pass through untouched; RGB(A) and palette sources are reduced
    with Rec.709 luma + round-half-up, matching the Rust image crate's
    into_luma8.
    """
    px, mode = read_png(path)
    if mode in ("L", "LA"):
        arr = px[..., 0]
    else:
        rgb = px[..., :3].astype(np.float32)
        luma = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
        arr = np.floor(luma + 0.5).clip(0, 255).astype(np.uint8)
    return arr.astype(np.float32) / 255.0


def save_png(pixels_u8: np.ndarray, path) -> None:
    """Save [H,W,3] (or [H,W] gray / [H,W,4] RGBA) uint8 to PNG."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(pixels_u8))

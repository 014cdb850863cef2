"""PNG reading and writing with the standard library's zlib and numpy.

Reads non-interlaced PNGs of 8- or 16-bit gray, gray + alpha, RGB and RGBA
(what TUM RGB-D sequences and mask caches hold: 8-bit colour, 16-bit depth,
8-bit masks) with all five row filters, and writes the same kinds with
filter 0. The CLIs read and write their images with it, so they need no
imaging library.

    img = png.read("depth/1305031790.000000.png")    # [H, W] uint16
    png.write("mask/1305031790.000000.png", mask)    # uint8 [H, W]
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}       # colour type -> samples per pixel
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _unfilter(ftype: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Undo the row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth). A
    pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal are independent: one vectorised step per
    anti-diagonal (H + W - 1 steps), each row with its own filter's
    predictor."""
    H, W, B = f.shape
    rec = np.zeros((H + 1, W + 1, B), np.int16)     # a zero row above, a zero column left
    f16 = f.astype(np.int16)
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H, d + 1))
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        t = ftype[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[ys + 1, xs + 1] = (f16[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read(path) -> np.ndarray:
    """The image as [H, W] (one channel) or [H, W, C], uint8 or uint16."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, bits, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or bits not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, {bits} bits, "
                         f"interlace {interlace}); 8/16-bit gray, gray+alpha, RGB or RGBA, "
                         "not interlaced, is read")
    ch = _CHANNELS[ctype]
    bpp = ch * bits // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:H * (1 + W * bpp)].reshape(H, 1 + W * bpp)
    ftype, f = raw[:, 0], raw[:, 1:].reshape(H, W, bpp)
    if ftype.max() > 4:
        raise ValueError(f"{path}: unknown row filter {ftype.max()}")
    img = _unfilter(ftype, f) if ftype.any() else f      # png.write's files: filter 0
    if bits == 16:
        img = np.ascontiguousarray(img).view(">u2").astype(np.uint16)
    img = img.reshape(H, W, ch)
    return img[..., 0] if ch == 1 else img


def write(path, img, level: int = 6) -> None:
    """A uint8 or uint16 image, [H, W] or [H, W, C] with C in 1-4, as a
    non-interlaced PNG with filter 0 on every row."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png.write: {a.dtype} image; uint8 or uint16 is written")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"png.write: image of shape {np.asarray(img).shape}")
    H, W, ch = a.shape
    bits = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if bits == 16 else a).view(np.uint8)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows.reshape(H, -1)], 1)
    header = struct.pack(">IIBBBBB", W, H, bits, _COLOUR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header) +
                 _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))

"""PNG files without an imaging library (the card's machine has neither
PIL nor matplotlib): 8-bit RGB or RGBA pixels, compressed with zlib, with
tEXt chunks for text.

    write_png(path, pixels, text={"Title": "..."})
    pixels, text = read_png(path)

The writer puts each row behind filter type 0 (none) in one IDAT chunk;
the reader takes what the writer writes (8-bit RGB or RGBA, no interlace,
filter 0 on every row) and raises on any other PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}  # channels -> PNG colour type (RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray, text: dict | None = None) -> str:
    """Write uint8 pixels [H, W, 3 or 4] to `path`, with `text` as tEXt
    chunks (keywords of 1-79 Latin-1 characters, values in Latin-1)."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"expected uint8 [H, W, 3|4] pixels, got {pixels.dtype} {pixels.shape}")
    h, w, c = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))]
    for key, value in (text or {}).items():
        if not 1 <= len(key) <= 79 or "\0" in key:
            raise ValueError(f"bad tEXt keyword {key!r}")
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + str(value).encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def read_png(path: str) -> tuple:
    """(uint8 pixels [H, W, 3|4], {keyword: text}) of a PNG as write_png
    writes it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, text = 8, None, [], {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("only filter type 0 (none) is read")
    return rows[:, 1:].reshape(h, w, channels).copy(), text

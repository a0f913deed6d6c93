"""Image files in and out, where the JAX package's ``test.py`` calls
``cv2.imread`` (``test.py:125, :140, :175``).

``imread(path)`` returns what ``cv2.imread(path)`` returns: a uint8 BGR
``[H, W, 3]`` array (alpha dropped, gray expanded to three channels), or
``None`` for a file that is missing or cannot be decoded.  It decodes with
cv2 where it can be imported, else with PIL, else with the standard library
and numpy:

* PNG at 8 bits per sample, colour types 0 (gray), 2 (RGB) and 6 (RGBA),
  not interlaced, with all five row filters (rows of filter None taken as
  they are, all at once; Sub and Up vectorized per row; Average and Paeth,
  whose bytes depend on their left neighbour, in a loop along the row);
* binary PGM and PPM (``P5``, ``P6``) with a maximum value of 255.

Any other file (JPEG among them) raises ``DecoderMissing``, naming the
decoder it needs: a machine with neither cv2 nor PIL reads only these.
``imwrite_png(path, image)`` writes a uint8 BGR or gray array as a PNG
(filter None on every row, zlib level 1), so datasets can be laid out where cv2 is
absent.

``imwrite_jpeg(path, image)`` writes a uint8 BGR array as a JPEG, where the
JAX repo's generators call ``cv2.imwrite(path, img)`` with a ``.jpg`` name:
through cv2 with its defaults (quality 95, 4:2:0) where it imports, else
through PIL at quality 95 (whose subsampling at that quality is 4:2:0
too; in this module's tests the two routes write the same bytes).  With
neither it raises ``EncoderMissing`` and writes nothing: PNG bytes never go
under a ``.jpg`` name.  cv2 and PIL are imported only inside the calls.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}         # colour type -> samples per pixel


class DecoderMissing(RuntimeError):
    """The file needs a decoder this machine does not have."""


class EncoderMissing(RuntimeError):
    """Writing the file needs an encoder this machine does not have."""


def imread(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (module docstring)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.imread(str(path))
    if not os.path.isfile(path):
        return None
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        try:
            with Image.open(path) as img:
                rgb = np.asarray(img.convert("RGB"))
        except OSError:
            return None
        return np.ascontiguousarray(rgb[..., ::-1])
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            return _to_bgr(decode_png(data))
        if data[:2] in (b"P5", b"P6"):
            return _to_bgr(decode_pnm(data))
    except (ValueError, zlib.error, struct.error):
        return None
    kind = "JPEG" if data.startswith(b"\xff\xd8\xff") else "this format"
    raise DecoderMissing(f"{path}: {kind} needs cv2 or PIL; without them "
                         "only 8-bit PNG and binary PGM/PPM are read")


def _to_bgr(pixels: np.ndarray) -> np.ndarray:
    """[H, W] gray, [H, W, 3] RGB or [H, W, 4] RGBA -> uint8 BGR."""
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


# ---- PNG ---------------------------------------------------------------------

def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced gray / RGB / RGBA PNG -> [H, W] or
    [H, W, C] uint8 samples.  Raises ``DecoderMissing`` for a PNG outside
    that set, ``ValueError`` (or ``zlib.error``) for a broken one."""
    header = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise DecoderMissing(
            f"PNG with {depth}-bit samples, colour type {colour}"
            f"{', interlaced' if interlace else ''} needs cv2 or PIL")
    bpp = _PNG_CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    raw = raw.reshape(height, stride + 1)
    filtered = np.flatnonzero(raw[:, 0])
    # rows of filter None are final as they stand; the others are undone
    # in order, each from the row above as it ends up
    out = raw[:, 1:].copy() if filtered.size else raw[:, 1:]
    zero = np.zeros(stride, np.uint8)
    for y in filtered:
        out[y] = _unfilter(int(raw[y, 0]), out[y], out[y - 1] if y else zero,
                           bpp)
    return out.reshape(height, width) if bpp == 1 else out.reshape(
        height, width, bpp)


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (PNG spec, section 9)."""
    if kind == 0:
        return row
    if kind == 1:                           # Sub: running sum per channel
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:                           # Up
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind}")
    cur = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:                       # Average
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def imwrite_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 BGR ``[H, W, 3]`` or gray ``[H, W]`` array as an 8-bit
    PNG: filter None on every row, zlib level 1."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"imwrite_png takes uint8 [H, W, 3] BGR or [H, W] "
                         f"gray, got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    if image.ndim == 3:
        colour, samples = 2, image[..., ::-1]
    else:
        colour, samples = 0, image
    rows = np.ascontiguousarray(samples).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                           colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def imwrite_jpeg(path: str, image: np.ndarray) -> None:
    """Write a uint8 BGR ``[H, W, 3]`` array as a JPEG, as ``cv2.imwrite``
    does with its defaults (module docstring); ``EncoderMissing`` where
    neither cv2 nor PIL imports."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"imwrite_jpeg takes uint8 [H, W, 3] BGR, got "
                         f"{image.dtype} {image.shape}")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(str(path), image):
            raise OSError(f"{path}: cv2.imwrite wrote nothing")
        return
    try:
        from PIL import Image
    except ImportError:
        raise EncoderMissing(f"{path}: a JPEG needs cv2 or PIL to encode, "
                             "and neither imports") from None
    Image.fromarray(np.ascontiguousarray(image[..., ::-1])).save(
        str(path), "JPEG", quality=95)


# ---- PGM / PPM ---------------------------------------------------------------

def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (``P5``) or PPM (``P6``) with maxval 255 -> [H, W] gray or
    [H, W, 3] RGB uint8."""
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos: pos + 1].isspace():
            pos += 1
        if data[pos: pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end: end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError("truncated PNM header")
        fields.append(int(data[pos:end]))
        pos = end
    width, height, maxval = fields
    if maxval != 255:
        raise DecoderMissing(f"PNM with maxval {maxval} needs cv2 or PIL")
    channels = 3 if data[:2] == b"P6" else 1
    n = width * height * channels
    body = np.frombuffer(data, np.uint8, count=n, offset=pos + 1)
    return body.reshape(height, width, channels) if channels == 3 else \
        body.reshape(height, width)

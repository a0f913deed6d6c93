"""Affine input warp as two matrix products, the counterpart of
``deft_tpu/ops/warp.py``.

Every transform of DEFT's preprocessing has rotation 0, so the warp is
separable: dst(y, x) = sum_j sum_i Ry[y, j] * src[j, i] * Rx[x, i], with 1-D
bilinear hat matrices Rx[x, i] = max(0, 1 - |a*x + b - i|).  It takes the
place of the reference's ``cv2.warpAffine`` (the port does not use cv2) and
runs on whatever device the frame lies on.  Border semantics match cv2's
BORDER_CONSTANT(0); cv2 quantizes its bilinear weights to 5 bits, so parity
with cv2 is within about one uint8 step, not bit-exact.  The output stays
float, with no uint8 round, as in the JAX package's device warp.

``warp_affine_uint8`` is the training pipeline's host warp, where the JAX
package calls ``cv2.warpAffine(img, trans, (w, h), flags=INTER_LINEAR)``
(``deft_tpu/data/generic_dataset.py:33-36``): numpy float32 arithmetic as
cv2's bilinear warp does it, for any affine (a rotation included) -- the
inverse map in double precision, source positions and the blend in float32,
the round to uint8, zeros outside the image.  It agrees with cv2 (5.0)
within one uint8 step.

``resize_linear`` is ``cv2.resize(img, (w, h))`` (INTER_LINEAR), which the
JAX detector runs for a test scale other than 1 (``deft_tpu/inference/
detector.py:191-194``): half-pixel centres, edge pixels repeated, and
cv2's fixed-point arithmetic for uint8 (11-bit weights, the horizontal
blend kept as int32, the vertical one as its vectorized loop does it).  It
agrees with cv2 (5.0) within one uint8 step.

``resize_cubic`` is ``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)``
of a float32 image, which the JAX repo's MOT generator runs for its
``--natural`` background (``tools/make_synthetic_mot.py:26``): separable,
Keys' kernel at a = -0.75 (cv2's coefficient), half-pixel centres, edge
pixels repeated, the sums in float64 and the result cast to float32.  It
agrees with cv2 (5.0) within 1e-6 (``tests/test_torch_port_synthetic.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from deft_tpu_torch.ops.affine import get_affine_transform


def hat_matrix(coef_a: float, coef_b: float, out_n: int, src_n: int,
               device=None) -> torch.Tensor:
    """[out_n, src_n] bilinear interpolation matrix for the 1-D affine map
    ``src = coef_a * dst + coef_b`` (pixel indices)."""
    src = (torch.tensor(coef_a, dtype=torch.float32, device=device)
           * torch.arange(out_n, dtype=torch.float32, device=device)
           + torch.tensor(coef_b, dtype=torch.float32, device=device))
    grid = torch.arange(src_n, dtype=torch.float32, device=device)
    return (1.0 - (src[:, None] - grid[None, :]).abs()).clamp(min=0.0)


def warp_affine_separable(image: torch.Tensor, inv_tf, out_h: int,
                          out_w: int) -> torch.Tensor:
    """Batched separable affine warp.

    image: [B, H, W, C] (uint8 or float); inv_tf: [6] flattened 2x3 INVERSE
    transform (dst -> src) with zero off-diagonal terms.  Returns float32
    [B, out_h, out_w, C] on the image's device.
    """
    _, h, w, _ = image.shape
    tf = [float(v) for v in np.asarray(inv_tf, np.float32).reshape(-1)]
    dev = image.device
    rx = hat_matrix(tf[0], tf[2], out_w, w, dev)             # [out_w, W]
    ry = hat_matrix(tf[4], tf[5], out_h, h, dev)             # [out_h, H]
    return warp_affine_with(image, rx, ry)


def warp_affine_with(image: torch.Tensor, rx: torch.Tensor,
                     ry: torch.Tensor) -> torch.Tensor:
    """The warp with its hat matrices given: [B, H, W, C] -> float32
    [B, out_h, out_w, C]."""
    t = torch.einsum("bhwc,ow->bhoc", image.float(), rx)
    return torch.einsum("bhoc,ph->bpoc", t, ry)


def separable_inverse_tf(c, s, out_w: int, out_h: int) -> np.ndarray:
    """The flattened inverse transform for the fix_res geometry, checking
    that it is separable (rotation 0 keeps the off-diagonals ~0)."""
    inv = np.asarray(get_affine_transform(c, s, 0, [out_w, out_h], inv=True),
                     np.float32)
    if abs(inv[0, 1]) >= 1e-5 or abs(inv[1, 0]) >= 1e-5:
        raise ValueError("non-separable affine (rotation != 0)")
    return inv.reshape(-1)


def _linear_taps(src_n: int, dst_n: int):
    """cv2's INTER_LINEAR taps along one axis: the first source index of
    each output position and its two weights in 1/2048 (int32)."""
    f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * (src_n / dst_n)
         - 0.5).astype(np.float32)
    idx = np.floor(f).astype(np.int64)
    f = f - idx.astype(np.float32)
    f[idx < 0] = 0.0
    idx = np.maximum(idx, 0)
    last = idx >= src_n - 1
    f[last] = 0.0
    idx[last] = src_n - 1
    w1 = np.rint(f * 2048.0).astype(np.int32)
    w0 = np.rint((1.0 - f) * 2048.0).astype(np.int32)
    return idx, np.minimum(idx + 1, src_n - 1), w0, w1


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` of a uint8 [H, W(, C)] image
    (module docstring) -> uint8 [out_h, out_w(, C)]."""
    h, w = img.shape[:2]
    src = (img if img.ndim == 3 else img[..., None]).astype(np.int32)
    x0, x1, a0, a1 = _linear_taps(w, out_w)
    y0, y1, b0, b1 = _linear_taps(h, out_h)
    rows = (src[:, x0] * a0[None, :, None]
            + src[:, x1] * a1[None, :, None])          # [H, out_w, C]
    top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    bottom = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    out = np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def _cubic_taps(src_n: int, dst_n: int, a: float = -0.75):
    """INTER_CUBIC's taps along one axis: [dst_n, 4] source indices (edges
    repeated) and their float64 weights."""
    f = (np.arange(dst_n, dtype=np.float64) + 0.5) * (src_n / dst_n) - 0.5
    first = np.floor(f)
    t = f - first
    w = np.empty((dst_n, 4))
    w[:, 0] = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w[:, 1] = ((a + 2) * t - (a + 3)) * t * t + 1
    w[:, 2] = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w[:, 3] = 1 - w[:, 0] - w[:, 1] - w[:, 2]
    idx = np.clip(first.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  src_n - 1)
    return idx, w


def resize_cubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_CUBIC)``
    of a float32 [H, W(, C)] image (module docstring) -> float32
    [out_h, out_w(, C)]."""
    h, w = img.shape[:2]
    src = (img if img.ndim == 3 else img[..., None]).astype(np.float64)
    xi, xw = _cubic_taps(w, out_w)
    yi, yw = _cubic_taps(h, out_h)
    rows = sum(src[:, xi[:, k]] * xw[None, :, k, None] for k in range(4))
    out = sum(rows[yi[:, k]] * yw[:, k, None, None] for k in range(4))
    out = out.astype(np.float32)
    return out if img.ndim == 3 else out[..., 0]


def warp_affine_uint8(img: np.ndarray, trans, out_w: int,
                      out_h: int) -> np.ndarray:
    """``cv2.warpAffine(img, trans, (out_w, out_h), flags=INTER_LINEAR)``
    of a uint8 [H, W, C] image under the 2x3 forward transform ``trans``
    (module docstring) -> uint8 [out_h, out_w, C]."""
    m = np.asarray(trans, np.float32).astype(np.float64).reshape(6).copy()
    # cv2 inverts the forward map in double precision (warpAffine)
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[4] = a11, a22
    m[1] *= -det
    m[3] *= -det
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    m = m.astype(np.float32)
    h, w = img.shape[:2]
    src = img if img.ndim == 3 else img[..., None]
    if abs(m[1]) < 1e-10 and abs(m[3]) < 1e-10:
        out = _warp_axis_aligned(src, m, out_w, out_h)
    else:
        out = _warp_general(src, m, out_w, out_h)
    return out if img.ndim == 3 else out[..., 0]


def _round_uint8(v: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _warp_general(src, m, out_w, out_h):
    """Every output pixel's four corners gathered: top = v00 + fx (v01 -
    v00), bottom likewise, then top + fy (bottom - top), in float32."""
    h, w = src.shape[:2]
    xs = np.arange(out_w, dtype=np.float32)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    sx = m[0] * xs + (m[1] * ys + m[2])
    sy = m[3] * xs + (m[4] * ys + m[5])
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    yi = y0.astype(np.int64)
    xi = x0.astype(np.int64)

    def corner(dy, dx):
        yy, xx = yi + dy, xi + dx
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return vals.astype(np.float32) * inb[..., None]

    top = corner(0, 0) + fx * (corner(0, 1) - corner(0, 0))
    bottom = corner(1, 0) + fx * (corner(1, 1) - corner(1, 0))
    return _round_uint8(top + fy * (bottom - top))


def _warp_axis_aligned(src, m, out_w, out_h):
    """The same float32 operations where the source column depends on the
    output column alone and the row on the row (no rotation): the
    horizontal blend once per source row that some output row reads, then
    the vertical blend."""
    h, w = src.shape[:2]
    sx = m[0] * np.arange(out_w, dtype=np.float32) + m[2]
    sy = m[4] * np.arange(out_h, dtype=np.float32) + m[5]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0)[None, :, None]
    fy = (sy - y0)[:, None, None]
    xi = x0.astype(np.int64)
    yi = y0.astype(np.int64)
    rows = np.unique(np.concatenate([yi, yi + 1]))
    rows = rows[(rows >= 0) & (rows < h)]

    def column(dx):
        xx = xi + dx
        inb = ((xx >= 0) & (xx < w)).astype(np.float32)[None, :, None]
        return src[rows][:, np.clip(xx, 0, w - 1)].astype(np.float32) * inb

    left = column(0)
    blended = left + fx * (column(1) - left)       # [len(rows), out_w, C]
    lookup = np.full(h + 2, -1, np.int64)
    lookup[rows + 1] = np.arange(len(rows))
    zero = np.zeros((1,) + blended.shape[1:], np.float32)
    blended = np.concatenate([blended, zero])        # row -1: outside

    def row(dy):
        yy = np.clip(yi + dy, -1, h)
        return blended[lookup[yy + 1]]

    top = row(0)
    return _round_uint8(top + fy * (row(1) - top))

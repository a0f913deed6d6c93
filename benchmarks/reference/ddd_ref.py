"""Plain reference of the nuScenes rig's 3-D decode and geometry.

Written from the published description of CenterTrack's monocular 3-D
output (the heads DEFT's nuScenes recipe trains: ``hm``, ``reg``, ``wh``,
``tracking``, ``dep``, ``rot``, ``dim``, ``amodel_offset``) and of the
nuScenes devkit's camera -> ego -> global chain, in float32 torch for the
head maps and float64 numpy for the geometry, with TF32 off and nothing of
the program under test:

* ``decode(heads, k, thr)``: one camera's NCHW head maps [C, h, w] (as
  ``deft_ref.Reference.heads`` gives them, batch index taken) -> the top-K
  peaks of the sigmoided heatmap above ``thr`` with every head read at the
  peak's cell: depth ``1 / sigmoid - 1``, the box ``(x + reg) -+ wh / 2``,
  the amodal centre the box centre plus ``amodel_offset``;
* ``alpha(rot)``: the 8-bin rotation head -> the observation angle (bin 1
  against bin 5 picks the half, each half's sine and cosine its angle,
  offset by -pi/2 or +pi/2);
* ``camera_results(dets, to_frame, calib)``: the decoded peaks in the
  frame's pixels (``to_frame``, the output grid's 2x3 affine to them), with
  the 3-D box in the camera: the amodal centre unprojected at the depth
  through ``calib`` [3, 4], lowered by half the height to the bottom
  centre, and ``rot_y = alpha + atan2(u - cx, fx)`` wrapped to [-pi, pi];
* ``Quat`` and ``global_box(loc, dim, rot_y, image_info)``: the box turned
  about the camera's y axis by ``rot_y``, raised to its centre, then
  rotated and shifted by the camera's record and by the ego pose's ->
  ``[h, w, l, x, y, z, yaw]`` with ``yaw`` the orientation's rotation angle
  signed by its axis's vertical component, as DEFT's tracker reads it.

Departures from DEFT's ``src/lib``: the top-K is one ``torch.topk`` over
all classes' cells (DEFT takes each class's top-K first, the same set where
scores are distinct); the geometry is float64 throughout (DEFT's
unprojection is float32: the gap is ~1e-6 of a location).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DDD_HEADS = ("tracking", "dep", "rot", "dim", "amodel_offset")


def sigmoid_clamped(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x).clamp(1e-4, 1.0 - 1e-4)


def peaks(hm: torch.Tensor) -> torch.Tensor:
    """A sigmoided [C, H, W] heatmap with every value that is not the
    maximum of its 3x3 neighbourhood set to 0."""
    return hm * (F.max_pool2d(hm[None], 3, 1, 1)[0] == hm).to(hm.dtype)


def decode(heads: Dict[str, torch.Tensor], k: int,
           thr: float) -> Dict[str, np.ndarray]:
    """One camera's heads {name: [C, h, w]} -> float64 arrays of the peaks
    scoring at least ``thr`` among the top ``k``, best first: ``score``,
    ``cls`` (0-based), ``cell`` [n, 2] (x, y), ``bbox`` [n, 4] in output
    cells, ``amodal_ct`` [n, 2], and the ``DDD_HEADS`` present (``dep``
    in metres, the others as the heads give them)."""
    hm = sigmoid_clamped(heads["hm"])
    c, h, w = hm.shape
    scores, idx = torch.topk(peaks(hm).reshape(-1), k)
    keep = scores >= thr
    idx = idx[keep]
    return at_cells(heads, (idx // (h * w)).cpu().numpy(),
                    torch.stack([idx % w, (idx % (h * w)) // w],
                                1).cpu().numpy())


def at_cells(heads: Dict[str, torch.Tensor], cls: np.ndarray,
             cells: np.ndarray) -> Dict[str, np.ndarray]:
    """``decode``'s fields at given cells [n, 2] (x, y) of classes ``cls``
    [n] (0-based): the score is the class's sigmoided heatmap there."""
    dev = heads["hm"].device
    cls = np.asarray(cls, np.int64).reshape(-1)
    cells = np.asarray(cells, np.int64).reshape(-1, 2)
    xs = torch.as_tensor(cells[:, 0], device=dev)
    ys = torch.as_tensor(cells[:, 1], device=dev)

    def at(name):
        return heads[name][:, ys, xs].t().double().cpu().numpy()

    hm = sigmoid_clamped(heads["hm"][torch.as_tensor(cls, device=dev), ys,
                                     xs])
    out = {"score": hm.double().cpu().numpy(), "cls": cls,
           "cell": cells.astype(np.float64)}
    x0, y0 = out["cell"][:, 0:1], out["cell"][:, 1:2]
    reg = at("reg") if "reg" in heads else np.full((len(x0), 2), 0.5)
    wh = np.maximum(at("wh"), 0.0)
    cx, cy = x0 + reg[:, 0:1], y0 + reg[:, 1:2]
    out["bbox"] = np.hstack([cx - wh[:, 0:1] / 2, cy - wh[:, 1:2] / 2,
                             cx + wh[:, 0:1] / 2, cy + wh[:, 1:2] / 2])
    for name in DDD_HEADS:
        if name in heads:
            out[name] = at(name)
    if "dep" in out:
        out["dep"] = 1.0 / (1.0 / (1.0 + np.exp(-out["dep"][:, 0])) + 1e-6) - 1.0
    centre = 0.5 * (out["bbox"][:, 0:2] + out["bbox"][:, 2:4])
    out["amodal_ct"] = centre + (out["amodel_offset"]
                                 if "amodel_offset" in out else 0.0)
    return out


def alpha(rot: np.ndarray) -> np.ndarray:
    """[n, 8] bins -> [n] observation angles."""
    rot = np.asarray(rot, np.float64)
    first = rot[:, 1] > rot[:, 5]
    a1 = np.arctan2(rot[:, 2], rot[:, 3]) - 0.5 * math.pi
    a2 = np.arctan2(rot[:, 6], rot[:, 7]) + 0.5 * math.pi
    return np.where(first, a1, a2)


def affine(to_frame: np.ndarray, pts: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    return pts @ to_frame[:, :2].T + to_frame[:, 2]


def camera_results(dets: Dict[str, np.ndarray], to_frame: np.ndarray,
                   calib: np.ndarray) -> Dict[str, np.ndarray]:
    """The decoded peaks in the frame's pixels with their camera-frame 3-D
    boxes: ``bbox`` [n, 4], ``ct`` [n, 2] (the amodal centre), ``loc``
    [n, 3] (bottom centre), ``rot_y``, ``alpha``, ``dim``, ``dep``,
    ``score`` and ``cls`` (1-based)."""
    calib = np.asarray(calib, np.float64)
    n = len(dets["score"])
    ct = affine(to_frame, dets["amodal_ct"])
    dep = dets["dep"]
    z = dep - calib[2, 3]
    x = (ct[:, 0] * dep - calib[0, 3] - calib[0, 2] * z) / calib[0, 0]
    y = (ct[:, 1] * dep - calib[1, 3] - calib[1, 2] * z) / calib[1, 1]
    dim = dets["dim"]
    loc = np.stack([x, y + dim[:, 0] / 2, z], axis=1)
    a = alpha(dets["rot"])
    rot_y = a + np.arctan2(ct[:, 0] - calib[0, 2], calib[0, 0])
    rot_y = np.where(rot_y > math.pi, rot_y - 2 * math.pi, rot_y)
    rot_y = np.where(rot_y < -math.pi, rot_y + 2 * math.pi, rot_y)
    return {"score": dets["score"], "cls": dets["cls"] + 1,
            "bbox": affine(to_frame, dets["bbox"].reshape(-1, 2)).reshape(
                n, 4),
            "ct": ct, "loc": loc, "rot_y": rot_y, "alpha": a, "dim": dim,
            "dep": dep}


# ---- camera -> ego -> global ----------------------------------------------

class Quat:
    """A unit quaternion (w, x, y, z), float64."""

    def __init__(self, wxyz):
        q = np.asarray(wxyz, np.float64)
        self.q = q / np.sqrt(np.sum(q * q))

    @classmethod
    def about(cls, axis, angle: float) -> "Quat":
        axis = np.asarray(axis, np.float64)
        axis = axis / np.sqrt(np.sum(axis * axis))
        return cls(np.r_[math.cos(angle / 2), math.sin(angle / 2) * axis])

    def __mul__(self, other: "Quat") -> "Quat":
        a, b = self.q, other.q
        return Quat([a[0] * b[0] - a[1:] @ b[1:],
                     *(a[0] * b[1:] + b[0] * a[1:] + np.cross(a[1:], b[1:]))])

    def rotate(self, v) -> np.ndarray:
        """q v q^-1 for a 3-vector v."""
        w, u = self.q[0], self.q[1:]
        v = np.asarray(v, np.float64)
        t = 2.0 * np.cross(u, v)
        return v + w * t + np.cross(u, t)

    def signed_angle(self) -> float:
        """The rotation angle in (-pi, pi], negated where the axis points
        down (an axis with no length points up)."""
        w, u = self.q[0], self.q[1:]
        norm = math.sqrt(float(u @ u))
        a = 2.0 * math.atan2(norm, w)
        if a > math.pi:
            a -= 2 * math.pi
        up = u[2] / norm if norm >= 1e-12 else 1.0
        return a if up > 0 else -a


def global_box(loc, dim, rot_y: float, info: dict) -> np.ndarray:
    """A camera-frame box (bottom centre ``loc``, ``dim`` [h, w, l], yaw
    ``rot_y`` about the camera's y) -> [h, w, l, x, y, z, yaw] in the
    global frame (``info``: the camera's ``cs_record_*`` and the ego's
    ``pose_record_*``)."""
    h = float(dim[0])
    centre = np.asarray(loc, np.float64) - [0.0, h / 2, 0.0]
    orient = Quat.about([0.0, 1.0, 0.0], float(rot_y))
    for rot, trans in ((info["cs_record_rot"], info["cs_record_trans"]),
                       (info["pose_record_rot"], info["pose_record_trans"])):
        q = Quat(rot)
        centre = q.rotate(centre) + np.asarray(trans, np.float64)
        orient = q * orient
    return np.r_[h, float(dim[1]), float(dim[2]), centre,
                 orient.signed_angle()]


def global_boxes(res: Dict[str, np.ndarray], info: dict,
                 rows: Optional[List[int]] = None) -> np.ndarray:
    rows = range(len(res["score"])) if rows is None else rows
    return np.array([global_box(res["loc"][i], res["dim"][i],
                                res["rot_y"][i], info)
                     for i in rows], np.float64).reshape(-1, 7)

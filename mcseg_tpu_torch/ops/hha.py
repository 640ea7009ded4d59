"""Depth -> HHA encoding on the device (Gupta et al., ECCV 2014 recipe).

The port of the JAX package's ``ops/hha.py``, batched: every plane is
[B, H, W], and vectors are carried as three planes (x, y, z).

  1. back-project depth to a camera-space point cloud (+Y up);
  2. unit normals from central-difference tangents (one-sided at the
     edges), oriented toward the camera;
  3. gravity in three rounds (thresholds 45 -> 15 degrees): the dominant
     eigenvector of sum_par n n^T - sum_perp n n^T;
  4. channels: disparity 31000 / depth_mm, height above the lowest valid
     point in cm, angle(normal, gravity) in degrees + 38; clipped to
     [0, 255]. Missing depth is set to 1e3 for the geometry and its HHA
     pixels are zeroed.

Each image's encoding is independent of the batch it comes in, bit for
bit, on the card too: every step is elementwise, the floor is a min, and
the Gram sums, which CUDA would split by the batch's size and round
differently, are exact (``_image_sums``). A rank that encodes part of a
batch gets what one process encoding the whole batch gets.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mcseg_tpu_torch.core.device import to_device
from mcseg_tpu_torch.utils.profiler import span

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # x, y, z as [B, H, W]


class CameraIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    def scaled(self, sx: float, sy: float) -> "CameraIntrinsics":
        return CameraIntrinsics(self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy)


# NYUDv2 Kinect intrinsics (Silberman toolbox), for 640x480 frames.
NYU_INTRINSICS = CameraIntrinsics(fx=582.62, fy=582.69, cx=313.04, cy=238.44)


def default_intrinsics(h: int, w: int) -> CameraIntrinsics:
    """Scale the NYU Kinect intrinsics to an arbitrary frame size."""
    return NYU_INTRINSICS.scaled(w / 640.0, h / 480.0)


def _point_cloud(depth: torch.Tensor, K: CameraIntrinsics) -> Planes:
    """[B,H,W] metres -> (x, y, z) camera-space planes, +Y pointing up."""
    _, h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[None, :, None]
    x = (u - K.cx) * depth / K.fx
    y = -(v - K.cy) * depth / K.fy  # image v grows down; flip so +Y is up
    return x, y, depth


def _central_diff(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences along ``dim`` (1 = H, 2 = W) of [B,H,W] planes,
    one-sided at the first and last row/column."""
    n = p.shape[dim]
    inner = (p.narrow(dim, 2, n - 2) - p.narrow(dim, 0, n - 2)) * 0.5
    first = p.narrow(dim, 1, 1) - p.narrow(dim, 0, 1)
    last = p.narrow(dim, n - 1, 1) - p.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def _normals(points: Planes) -> Planes:
    """Unit surface normals oriented toward the camera, as planes."""
    dux, duy, duz = (_central_diff(p, 2) for p in points)
    dvx, dvy, dvz = (_central_diff(p, 1) for p in points)
    nx = duy * dvz - duz * dvy
    ny = duz * dvx - dux * dvz
    nz = dux * dvy - duy * dvx
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz).clamp_min(1e-8)
    nx, ny, nz = nx / norm, ny / norm, nz / norm
    px, py, pz = points
    # the view ray is the point itself; orient so that n . view < 0
    sign = torch.where((nx * px + ny * py + nz * pz) > 0, -1.0, 1.0)
    return nx * sign, ny * sign, nz * sign


GRAVITY_ROUNDS = 3
# (parallel, perpendicular) angle thresholds of each round in radians, as
# Python floats rounded to float32 as the JAX version rounds them: nothing
# in the encoder reads tensor data on the host, so torch.export traces it
_ANNEAL = (np.linspace(45.0, 15.0, GRAVITY_ROUNDS).astype(np.float32)
           * np.float32(math.pi) / np.float32(180.0))
_THRESHOLDS = tuple((float(t), float(np.float32(math.pi / 2) - t)) for t in _ANNEAL)


# fixed-point scale of the Gram sums: terms are products of unit normals
# (|t| <= 1), so a term fits int32 and an image of up to 2^32 pixels sums
# within int64
_FIXED_POINT = 2.0 ** 30


def _image_sums(mask: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    """Per-image sums of ``mask`` [B,H,W] (0 or 1) times each of the planes
    ``scaled`` [P,B,H,W] (values in [-1, 1] times 2^30), float32 [P,B]: each
    term an int32 multiple of 2^-30 (exact for |t| >= 2^-7, truncated
    below), summed in int64. Integer sums are exact in any order, so an
    image's sum is the same bits whatever the batch (a float32 ``torch.sum``
    on the card splits its work by the number of images and rounds
    accordingly); the truncation of the terms is far below float32's own
    rounding in the sum."""
    fixed = (mask[None] * scaled).to(torch.int32)
    return (fixed.sum(dim=(2, 3), dtype=torch.int64).to(torch.float64)
            / _FIXED_POINT).to(torch.float32)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [B, 3] vectors, elementwise (no reduction
    kernel whose split depends on B)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def estimate_gravity(normals: Planes, valid: torch.Tensor) -> torch.Tensor:
    """Per-image gravity direction [B, 3] (unit, roughly +Y).

    Normals within ``thr`` of the current estimate count as parallel
    (floors), those within ``thr`` of its orthogonal plane as perpendicular
    (walls); the new estimate is the eigenvector of the largest eigenvalue
    of sum_par n n^T - sum_perp n n^T, flipped to point along the old one.
    Thresholds anneal linearly from 45 to 15 degrees."""
    nx, ny, nz = normals
    b = nx.shape[0]
    g = to_device(torch.tensor([0.0, 1.0, 0.0]), nx.device).repeat(b, 1)
    w2 = valid.to(torch.float32) ** 2  # (w n)(w n)^T carries w^2
    # the six products of n n^T in fixed point, for every round's sums
    scaled = torch.stack((nx * nx, nx * ny, nx * nz, ny * ny, ny * nz, nz * nz)) * _FIXED_POINT

    def gram(mask):
        xx, xy, xz, yy, yz, zz = _image_sums(mask * w2, scaled)
        return torch.stack([torch.stack([xx, xy, xz], -1),
                            torch.stack([xy, yy, yz], -1),
                            torch.stack([xz, yz, zz], -1)], -2)

    for thr, perp_thr in _THRESHOLDS:
        gx, gy, gz = (g[:, k, None, None] for k in range(3))
        cos = torch.abs(nx * gx + ny * gy + nz * gz)
        ang = torch.arccos(cos.clamp(-1.0, 1.0))
        m = gram((ang < thr).to(torch.float32)) - gram((ang > perp_thr).to(torch.float32))
        with span("host_wait"):  # eigh checks its result on the host
            _, vecs = torch.linalg.eigh(m)  # ascending eigenvalues
        cand = vecs[:, :, -1]
        cand = torch.where(_dot3(cand, g)[:, None] < 0, -cand, cand)
        g = cand / torch.sqrt(_dot3(cand, cand)).clamp_min(1e-8)[:, None]
    return g


def depth_to_hha(depth: torch.Tensor) -> torch.Tensor:
    """One [H,W] depth map in metres -> [H,W,3] float32 HHA in [0, 255]."""
    return depth_to_hha_batch(depth[None])[0]


def depth_to_hha_batch(depth: torch.Tensor, K: Optional[CameraIntrinsics] = None
                       ) -> torch.Tensor:
    """[B,H,W] metres (0 / non-finite = missing) -> [B,H,W,3] float32 HHA
    in [0, 255], with the camera ``K`` (default: the NYU Kinect intrinsics
    scaled to the frame size). A profiled run marks it as the span
    ``hha``."""
    with span("hha"):
        return _hha(depth, K)


def _hha(depth: torch.Tensor, K: Optional[CameraIntrinsics]) -> torch.Tensor:
    depth = depth.to(torch.float32)
    _, h, w = depth.shape
    K = K or default_intrinsics(h, w)
    valid = torch.isfinite(depth) & (depth > 1e-3)
    d = torch.where(valid, depth, 1e3)  # missing -> far away

    px, py, pz = _point_cloud(d, K)
    nx, ny, nz = _normals((px, py, pz))
    g = estimate_gravity((nx, ny, nz), valid)
    gx, gy, gz = (g[:, k, None, None] for k in range(3))

    disparity = 31000.0 / (d * 1000.0)
    height = px * gx + py * gy + pz * gz
    floor = torch.where(valid, height, math.inf).amin(dim=(1, 2), keepdim=True)
    floor = torch.where(torch.isfinite(floor), floor, 0.0)
    height_cm = (height - floor) * 100.0
    cos_a = (nx * gx + ny * gy + nz * gz).clamp(-1.0, 1.0)
    angle = torch.rad2deg(torch.arccos(cos_a)) + 38.0

    hha = torch.stack([disparity, height_cm, angle], dim=-1)
    hha = torch.where(valid[..., None], hha, 0.0)
    return hha.clamp(0.0, 255.0)

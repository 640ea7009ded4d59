"""Plain reference of the depth -> HHA encoding (Gupta et al., ECCV 2014),
batched over [B, H, W] depth planes in metres.

1. back-project with the NYUDv2 Kinect intrinsics scaled to the frame
   (+Y up);
2. unit normals from central differences (one-sided at the edges),
   oriented toward the camera;
3. gravity in three rounds, thresholds annealed from 45 to 15 degrees: the
   top eigenvector of sum_parallel n n^T - sum_perpendicular n n^T, flipped
   to point along the previous estimate;
4. channels: disparity 31000 / depth_mm, height above the lowest valid
   point in cm, the angle between normal and gravity in degrees + 38;
   clipped to [0, 255], missing depth (0 or not finite) zeroed and placed
   at 1e3 m for the geometry.

The Gram sums are taken in float64, the rest in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FX, FY, CX, CY = 582.62, 582.69, 313.04, 238.44  # for 640x480 frames
ROUNDS = 3


def _diff(p: torch.Tensor, dim: int) -> torch.Tensor:
    n = p.shape[dim]
    inner = (p.narrow(dim, 2, n - 2) - p.narrow(dim, 0, n - 2)) * 0.5
    first = p.narrow(dim, 1, 1) - p.narrow(dim, 0, 1)
    last = p.narrow(dim, n - 1, 1) - p.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def _gravity(n: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """n [B, 3, H, W] unit normals -> [B, 3] gravity."""
    b = n.shape[0]
    g = torch.tensor([0.0, 1.0, 0.0], device=n.device).repeat(b, 1)
    w = valid.to(torch.float64)
    n64 = n.to(torch.float64)
    thresholds = (np.linspace(45.0, 15.0, ROUNDS).astype(np.float32)
                  * np.float32(math.pi) / np.float32(180.0))
    for thr in thresholds:
        perp = float(np.float32(math.pi / 2) - thr)
        ang = torch.arccos((n * g[:, :, None, None]).sum(1).abs().clamp(-1.0, 1.0))
        m = ((ang < float(thr)).to(torch.float64) - (ang > perp).to(torch.float64)) * w
        gram = torch.einsum("bhw,bihw,bjhw->bij", m, n64, n64).to(torch.float32)
        vec = torch.linalg.eigh(gram)[1][:, :, -1]
        vec = torch.where((vec * g).sum(1, keepdim=True) < 0, -vec, vec)
        g = vec / vec.norm(dim=1, keepdim=True).clamp_min(1e-8)
    return g


def depth_to_hha(depth: torch.Tensor) -> torch.Tensor:
    """[B, H, W] metres -> [B, H, W, 3] float32 HHA in [0, 255]."""
    depth = depth.to(torch.float32)
    _, h, w = depth.shape
    sx, sy = w / 640.0, h / 480.0
    fx, fy, cx, cy = FX * sx, FY * sy, CX * sx, CY * sy
    valid = torch.isfinite(depth) & (depth > 1e-3)
    d = torch.where(valid, depth, 1e3)
    u = torch.arange(w, dtype=torch.float32, device=d.device)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=d.device)[None, :, None]
    p = torch.stack([(u - cx) * d / fx, -(v - cy) * d / fy, d], dim=1)  # [B,3,H,W]
    du, dv = _diff(p, 3), _diff(p, 2)
    n = torch.cross(du, dv, dim=1)
    n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-8)
    n = torch.where((n * p).sum(1, keepdim=True) > 0, -n, n)
    g = _gravity(n, valid)[:, :, None, None]
    height = (p * g).sum(1)
    floor = torch.where(valid, height, math.inf).amin(dim=(1, 2), keepdim=True)
    floor = torch.where(torch.isfinite(floor), floor, 0.0)
    angle = torch.rad2deg(torch.arccos((n * g).sum(1).clamp(-1.0, 1.0))) + 38.0
    hha = torch.stack([31000.0 / (d * 1000.0), (height - floor) * 100.0, angle], dim=-1)
    return torch.where(valid[..., None], hha, 0.0).clamp(0.0, 255.0)

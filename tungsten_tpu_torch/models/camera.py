"""The pinhole camera with the box reconstruction filter (the pinhole path
of tungsten_tpu/models/camera.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.vecmath import normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    transform: torch.Tensor  # [4, 4] camera-to-world
    fov_deg: torch.Tensor  # scalar
    res_x: int
    res_y: int

    @staticmethod
    def create(transform, fov_deg, res, device):
        return Camera(
            transform=torch.as_tensor(np.asarray(transform, np.float32),
                                      device=device),
            fov_deg=torch.tensor(float(fov_deg), dtype=torch.float32,
                                 device=device),
            res_x=int(res[0]), res_y=int(res[1]))

    def sample_ray(self, px, py, u_filter):
        """Ray (ro, rd) [R, 3] through pixel (px, py) [R] at sub-pixel jitter
        u_filter [R, 2] in [0, 1)."""
        plane_dist = 1.0 / torch.tan(torch.deg2rad(self.fov_deg) * 0.5)
        ratio = self.res_y / self.res_x
        pixel_size = 1.0 / self.res_x
        uv = u_filter - 0.5
        local_d = torch.stack([
            -1.0 + (px.to(torch.float32) + 0.5 + uv[:, 0]) * 2.0 * pixel_size,
            ratio - (py.to(torch.float32) + 0.5 + uv[:, 1]) * 2.0
            * pixel_size,
            plane_dist.expand(px.shape),
        ], dim=-1)
        local_d = normalize(local_d)
        m = self.transform
        rd = (m[:3, 0] * local_d[:, 0:1] + m[:3, 1] * local_d[:, 1:2]
              + m[:3, 2] * local_d[:, 2:3])
        return m[:3, 3].expand(rd.shape), rd

"""Gaussian scene state as a dataclass of tensors.

Counterpart of goi_tpu/core/scene.py: raw (pre-activation) parameters
with a fixed capacity N and a boolean validity mask, so densify/prune
can flip mask bits instead of reallocating.

Activations match the reference (ref:scene/gaussian_model.py:22-30):
  scaling  = exp(_scaling)
  opacity  = sigmoid(_opacity)
  rotation = l2-normalize(_rotation)
  features = concat(dc, rest) SH coeffs
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianScene:
    """All per-Gaussian parameters, pre-activation, shape-leading N.

    xyz:           (N, 3)  world positions
    features_dc:   (N, 1, 3)  SH DC coefficients
    features_rest: (N, (deg+1)^2 - 1, 3)  higher-order SH coefficients
    semantics:     (N, S)  low-dim semantic features
    scaling:       (N, 3)  log-scales
    rotation:      (N, 4)  unnormalized quaternions (w, x, y, z)
    opacity:       (N, 1)  opacity logits
    valid:         (N,)    capacity mask; invalid rows never rasterize
    """

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    semantics: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    # trainable leaves, in reference param-group order
    # (ref:scene/gaussian_model.py:168-176)
    PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "semantics",
                    "opacity", "scaling", "rotation")

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def params(self) -> dict:
        """Trainable float tensors as a dict; excludes the bool validity
        mask and the SH-degree metadata."""
        return {k: getattr(self, k) for k in self.PARAM_FIELDS}

    def with_params(self, p: dict) -> "GaussianScene":
        return dataclasses.replace(self, **p)

    def to(self, device) -> "GaussianScene":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def num_valid(self):
        return self.valid.sum()

    @property
    def sem_dim(self) -> int:
        return self.semantics.shape[-1]

    # ---- activations (match reference semantics) ----
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        # clamp the SQUARED norm: for |q| ~ 1e-30 the square underflows
        # to 0 in fp32 and sqrt's derivative at 0 is inf -> NaN grads
        n2 = torch.sum(self.rotation * self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.sqrt(torch.clamp(n2, min=1e-24))

    def get_features(self) -> torch.Tensor:
        """(N, (deg+1)^2, 3) stacked SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_semantics(self, masks: Optional[torch.Tensor] = None):
        """Semantic features, optionally gated by a per-Gaussian mask
        (ref:scene/gaussian_model.py:108-123)."""
        if masks is None:
            return self.semantics
        return self.semantics * masks[:, None]

    def get_covariance(self, scaling_modifier: float = 1.0):
        """(N, 6) packed upper-triangular world covariance
        (xx, xy, xz, yy, yz, zz) (ref:cuda_rasterizer/forward.cu:118-152)."""
        return build_cov3d(self.get_scaling() * scaling_modifier,
                           self.get_rotation())

    def one_up_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            return dataclasses.replace(
                self, active_sh_degree=self.active_sh_degree + 1)
        return self

    def replace(self, **kw) -> "GaussianScene":
        return dataclasses.replace(self, **kw)

    # ---- construction ----
    @staticmethod
    def create(xyz: np.ndarray, colors: Optional[np.ndarray] = None, *,
               sh_degree: int = 3, sem_dim: int = 10,
               scales: Optional[np.ndarray] = None,
               capacity: Optional[int] = None,
               dtype=torch.float32, device="cuda") -> "GaussianScene":
        """Initialize from a point cloud as create_from_pcd does
        (ref:scene/gaussian_model.py:133-161): colors -> SH DC, isotropic
        log-scales (default 0.01), identity quaternions, opacity logit
        of 0.1. Capacity rows beyond n are padded invalid."""
        from goi_tpu_torch.core.sh import rgb_to_sh

        n = xyz.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} points")
        n_rest = (sh_degree + 1) ** 2 - 1

        def pad(a, fill=0.0):
            if a.shape[0] == cap:
                return a
            pad_width = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, pad_width, constant_values=fill)

        xyz = np.asarray(xyz, np.float32)
        if colors is None:
            colors = np.zeros_like(xyz) + 0.5
        f_dc = rgb_to_sh(np.asarray(colors, np.float32))[:, None, :]
        f_rest = np.zeros((n, n_rest, 3), np.float32)
        sems = np.zeros((n, sem_dim), np.float32)
        if scales is None:
            scales = np.full((n,), 0.01, np.float32)
        log_scales = np.log(np.asarray(scales, np.float32))[:, None].repeat(
            3, 1)
        rots = np.zeros((n, 4), np.float32)
        rots[:, 0] = 1.0
        opa = np.full((n, 1), float(np.log(0.1 / 0.9)), np.float32)
        valid = np.zeros((cap,), bool)
        valid[:n] = True

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return GaussianScene(
            xyz=t(pad(xyz)),
            features_dc=t(pad(f_dc)),
            features_rest=t(pad(f_rest)),
            semantics=t(pad(sems)),
            scaling=t(pad(log_scales, fill=-10.0)),
            rotation=t(pad(rots)),
            opacity=t(pad(opa, fill=-20.0)),
            valid=torch.as_tensor(valid, device=device),
            active_sh_degree=0,
            max_sh_degree=sh_degree,
        )


def build_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> (...,3,3) rotation matrix, the formula of
    ref:cuda_rasterizer/forward.cu:134-138. Expects normalized quats."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
        -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
        -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
        -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """World covariance Sigma = R diag(s^2) R^T, packed upper-triangular
    (xx, xy, xz, yy, yz, zz) (ref:cuda_rasterizer/forward.cu:140-152)."""
    R = build_rotation_matrix(quats)
    RS = R * (scales[..., None, :] ** 2)
    sigma = torch.einsum("...ik,...jk->...ij", RS, R)
    return torch.stack([sigma[..., 0, 0], sigma[..., 0, 1],
                        sigma[..., 0, 2], sigma[..., 1, 1],
                        sigma[..., 1, 2], sigma[..., 2, 2]], dim=-1)

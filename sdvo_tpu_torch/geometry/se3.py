"""Batched SE(3) on torch tensors — port of ``sdvo_tpu.geometry.se3``.

Rotation matrix ``(..., 3, 3)`` + translation ``(..., 3)`` in a NamedTuple;
tangent convention ``tau = [upsilon, omega]`` (translation first), as Sophus
and the JAX reference. Nothing on the port's path needs gradients, so the
small-angle branches are plain ``torch.where`` selects.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-8


class SE3(NamedTuple):
    """A (batch of) rigid transform(s): ``x_out = R @ x + t``."""

    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)

    @property
    def dtype(self):
        return self.translation.dtype

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return SE3(R, t)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other (apply ``other`` first)."""
        R = self.rotation @ other.rotation
        t = (self.rotation @ other.translation[..., None])[..., 0] + self.translation
        return SE3(R, t)

    def inverse(self) -> "SE3":
        Rt = self.rotation.transpose(-1, -2)
        return SE3(Rt, -(Rt @ self.translation[..., None])[..., 0])

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points (..., 3) (broadcasts over leading dims)."""
        return torch.einsum("...ij,...j->...i", self.rotation, points) + self.translation

    def rotate(self, vecs: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.rotation, vecs)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew operator (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_s)
    W = hat(omega)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_s)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3); same branches as the JAX reference."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - 1e-6
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    near_pi = theta > math.pi - 1e-3
    sin_s = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    c1 = 1.0 - cos_theta
    scale = torch.where(small, 1.0 + c1 / 3.0 + c1 * c1 * (2.0 / 15.0), theta / sin_s)
    omega_generic = scale[..., None] * w
    sym = 0.5 * (R + R.transpose(-1, -2))
    denom = torch.clamp(1.0 - cos_theta, min=1e-9)
    outer = (sym - cos_theta[..., None, None] * _eye_like(R)) / denom[..., None, None]
    diag = torch.diagonal(outer, dim1=-2, dim2=-1)
    best = torch.argmax(diag, dim=-1)
    axis = torch.gather(outer, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-12)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    omega_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], omega_pi, omega_generic)


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_s)
    W = hat(omega)
    W2 = W @ W
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_s * theta))
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inverse(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_s)
    W = hat(omega)
    W2 = W @ W
    half = 0.5 * theta
    cot = torch.cos(half) / torch.where(small, torch.ones_like(theta), torch.sin(half))
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - 0.5 * theta * cot) / theta2_s)
    return _eye_like(W) - 0.5 * W + k[..., None, None] * W2


def exp(tau: torch.Tensor) -> SE3:
    """se(3) exp: (..., 6) [upsilon, omega] -> SE3."""
    upsilon, omega = tau[..., :3], tau[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ upsilon[..., None])[..., 0]
    return SE3(R, t)


def log(T: SE3) -> torch.Tensor:
    """SE3 -> (..., 6) [upsilon, omega]."""
    omega = so3_log(T.rotation)
    upsilon = (_left_jacobian_inverse(omega) @ T.translation[..., None])[..., 0]
    return torch.cat([upsilon, omega], dim=-1)

"""Batched closed-form 3x3 linear algebra (port of
:mod:`beam_slam_tpu.ops.mat3`).

The cofactor/adjugate form is elementwise math over the batch, with no
per-matrix factorization. Callers must damp/floor their blocks away from
singularity (the adjugate divides by det).
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Cofactor inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    rows = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return rows * (1.0 / det)[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b for [..., 3, 3] @ [..., 3] via the cofactor inverse."""
    return torch.einsum("...ij,...j->...i", inv3x3(A), b)

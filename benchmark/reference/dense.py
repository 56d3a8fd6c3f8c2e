"""Dense SPD solve for the plain references: a blocked right-looking
Cholesky in plain PyTorch.

Each diagonal block is factored by the library (``cholesky_ex``), the
panel below it by a triangular solve, and the trailing matrix is updated
by one matrix product per panel. The products follow PyTorch's matmul
precision settings, so the same code run in float32 with TF32 allowed is
the lower-precision control of the benchmark's correctness check.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 512


def cholesky_solve(H: torch.Tensor, g: torch.Tensor, block: int = BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = g for a batch of SPD systems (H [B, N, N], only the lower
    triangle read; g [B, N]). Returns (x [B, N], ok [B] bool); a system
    whose factorization meets a non-positive pivot gets x = NaN and
    ok = False."""
    A = torch.tril(H)
    B, N = g.shape
    ok = torch.ones(B, dtype=torch.bool, device=H.device)
    for k0 in range(0, N, block):
        k1 = min(k0 + block, N)
        Lkk, info = torch.linalg.cholesky_ex(A[:, k0:k1, k0:k1])
        ok = ok & (info == 0)
        A[:, k0:k1, k0:k1] = Lkk
        if k1 < N:
            # L_ik = A_ik L_kk⁻ᵀ, then A_jj -= L_ik L_ikᵀ on the trailing rows
            Lik = torch.linalg.solve_triangular(
                Lkk, A[:, k1:, k0:k1].transpose(-1, -2),
                upper=False).transpose(-1, -2)
            A[:, k1:, k0:k1] = Lik
            A[:, k1:, k1:] -= Lik @ Lik.transpose(-1, -2)
    L = torch.tril(A)
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                      upper=True)[..., 0]
    x = torch.where(ok[:, None], x, torch.full_like(x, float("nan")))
    return x, ok

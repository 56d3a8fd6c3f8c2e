"""Plain reference of the batched LVIO-window LM solve, in plain PyTorch.

The same mathematics as the program's shared-topology batched solve:
every family linearized (:mod:`.factors`), Cauchy IRLS weights, the dense
normal equations over the window's tangent plus one padding ("trash") dof
(each factor's JᵀJ, Jᵀr and rᵀr from one product, the Gram matrix of
[J | J_landmark | r], so that a lower precision of products reaches the
gradient and the cost as well as the Hessian),
the landmarks Schur-eliminated through damped 3×3 blocks (λ·diag(H_ll) +
1e-8 + 1e-5·tr(H_ll)), held dof masked to a unit row, Jacobi
equilibration, ``+ λI``, the dense solve of :mod:`.dense`, landmark
back-substitution, and the LM accept test, λ schedule and ``done`` latch
(relative cost drop under ``function_tolerance``), for exactly ``n_iter``
steps.

Run in float64 it is the reference; in float32 with TF32 allowed, the
control. The window and families are this folder's own types
(:mod:`.window`, :mod:`.factors`), filled from the traffic generator's
plain tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from benchmark.reference import window as win
from benchmark.reference.dense import cholesky_solve
from benchmark.reference.window import LANDMARK_DOF, WindowState


class Options(NamedTuple):
    n_iter: int = 10
    function_tolerance: float = 1e-6
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8


def robust_weight(sq_norm, loss_scale: Optional[float]):
    """IRLS weight and cost: Cauchy ρ(s) = c²·log(1 + s/c²), ρ'(s)."""
    if loss_scale is None:
        return torch.ones_like(sq_norm), sq_norm
    c2 = loss_scale * loss_scale
    return 1.0 / (1.0 + sq_norm / c2), c2 * torch.log1p(sq_norm / c2)


def _scatter_add(target, index, values):
    """target (flattened over its trailing dims)[..., index] += values; the
    index is shared by the batch."""
    n_lead = values.dim() - index.dim()
    nb = 1
    for s in target.shape[:n_lead]:
        nb *= s
    target.view(nb, -1).index_add_(1, index.reshape(-1),
                                   values.reshape(nb, -1))


def assemble(window: WindowState, families: Sequence,
             losses: Tuple[Optional[float], ...]):
    """(H [B, D+1, D+1], g, H_ll [B, L, 3, 3], g_l, W [B, D+1, 3L], cost)."""
    lead = window.imu.q.shape[:-2]
    D = window.num_dense_dof
    L = window.landmarks.capacity
    dtype, dev = window.imu.q.dtype, window.imu.q.device
    z = lambda *s: torch.zeros(lead + s, dtype=dtype, device=dev)  # noqa: E731
    H, g = z(D + 1, D + 1), z(D + 1)
    H_ll, g_l = z(L, 3, 3), z(L, 3)
    W = z(D + 1, L * LANDMARK_DOF)
    cost = z()
    k3 = torch.arange(LANDMARK_DOF, device=dev)
    for fam, loss in zip(families, losses):
        r, J, col, _, lm_slot, J_lm = fam.linearize(window)
        # one product per factor: the Gram matrix of [J | J_lm | r]
        parts = [J] + ([J_lm] if lm_slot is not None else []) + [r[..., None]]
        Ja = torch.cat(parts, dim=-1)
        G = torch.einsum("...ri,...rj->...ij", Ja, Ja)
        w, rho = robust_weight(G[..., -1, -1], loss)
        cost = cost + 0.5 * torch.sum(rho, dim=-1)
        G = G * w[..., None, None]
        k = J.shape[-1]
        _scatter_add(g, col, -G[..., :k, -1])
        _scatter_add(H, col[..., :, None] * (D + 1) + col[..., None, :],
                     G[..., :k, :k])
        if lm_slot is not None:
            lm_cols = lm_slot[..., None] * LANDMARK_DOF + k3
            _scatter_add(H_ll, lm_cols[..., :, None] * LANDMARK_DOF + k3,
                         G[..., k:k + 3, k:k + 3])
            _scatter_add(g_l, lm_cols, -G[..., k:k + 3, -1])
            _scatter_add(W, col[..., :, None] * (L * LANDMARK_DOF)
                         + lm_cols[..., None, :], G[..., :k, k:k + 3])
    return H, g, H_ll, g_l, W, cost


def total_cost(window: WindowState, families: Sequence,
               losses: Tuple[Optional[float], ...]):
    """The robustified cost [B] of every window, without Jacobians."""
    cost = torch.zeros(window.imu.q.shape[:-2], dtype=window.imu.q.dtype,
                       device=window.imu.q.device)
    for fam, loss in zip(families, losses):
        r = fam.residual_only(window)
        _, rho = robust_weight(torch.sum(r * r, dim=-1), loss)
        cost = cost + 0.5 * torch.sum(rho, dim=-1)
    return cost


def inv3x3(A):
    """Cofactor inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    rows = torch.stack([torch.stack([c00, c01, c02], -1),
                        torch.stack([c10, c11, c12], -1),
                        torch.stack([c20, c21, c22], -1)], -2)
    return rows * (1.0 / det)[..., None, None]


def _solve_damped(H, g, free, lam, H_ll, g_l, W, lm_free):
    """The Schur-reduced damped step: (δ dense, δ landmarks, ok)."""
    dtype, dev = H.dtype, H.device
    Dp, L = H.shape[-1], H_ll.shape[-3]
    lead = H.shape[:-2]
    freef, lmf = free.to(dtype), lm_free.to(dtype)
    lam = lam[..., None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hm = H * (freef[..., :, None] * freef[..., None, :])
    Hm = Hm + torch.diag_embed(1.0 - freef)
    gm = g * freef
    W = W * freef[..., :, None] * torch.repeat_interleave(
        lmf, LANDMARK_DOF, dim=-1)[..., None, :]
    diag_ll = torch.diagonal(H_ll, dim1=-2, dim2=-1)
    tr = torch.sum(diag_ll, dim=-1)
    Hll_d = (H_ll + torch.diag_embed(lam * diag_ll + 1e-8)
             + (1e-5 * tr)[..., None, None] * eye3)
    Hll_d = torch.where(lmf[..., None, None] > 0, Hll_d, eye3)
    g_l = g_l * lmf[..., None]
    Hll_inv = inv3x3(Hll_d)
    Wr = W.reshape(lead + (Dp, L, 3))
    Y = torch.einsum("...dlk,...lkm->...dlm", Wr, Hll_inv)
    H_red = Hm - torch.einsum("...dlm,...elm->...de", Y, Wr)
    g_red = gm - torch.einsum("...dlm,...lm->...d", Y, g_l)
    s = torch.rsqrt(torch.clamp(torch.diagonal(H_red, dim1=-2, dim2=-1),
                                min=1e-12))
    Hs = H_red * (s[..., :, None] * s[..., None, :])
    Hs = Hs + lam * torch.eye(Dp, dtype=dtype, device=dev)
    y, _ = cholesky_solve(Hs.reshape(-1, Dp, Dp), (g_red * s).reshape(-1, Dp))
    delta = y.reshape(g.shape) * s * freef
    rhs_l = g_l - torch.einsum("...dlk,...d->...lk", Wr, delta)
    delta_l = torch.einsum("...lkm,...lk->...lm", Hll_inv, rhs_l) \
        * lmf[..., None]
    ok = (torch.isfinite(delta).all(dim=-1)
          & torch.isfinite(delta_l).flatten(-2).all(dim=-1))
    delta = torch.where(ok[..., None], delta, torch.zeros_like(delta))
    delta_l = torch.where(ok[..., None, None], delta_l,
                          torch.zeros_like(delta_l))
    return delta, delta_l, ok


def solve(window: WindowState, families, losses, options: Options):
    """LM over the batch of windows. Returns (window, initial cost [B],
    final cost [B])."""
    free_full = window.dense_free_mask()
    free = torch.cat([free_full, torch.zeros_like(free_full[..., :1])], -1)
    lm_free = window.landmarks.active & ~window.landmarks.held
    H, g, H_ll, g_l, W, cost = assemble(window, families, losses)
    init_cost = cost
    lam = torch.full_like(cost, options.initial_lambda)
    done = torch.zeros_like(cost, dtype=torch.bool)

    def sel(accept, new, old):
        return torch.where(accept.reshape(
            accept.shape + (1,) * (new.dim() - accept.dim())), new, old)

    for _ in range(options.n_iter):
        active = ~done
        delta, delta_l, ok = _solve_damped(H, g, free, lam, H_ll, g_l, W,
                                           lm_free)
        trial = window.retract_dense(delta[..., :-1])
        trial = trial.replace(landmarks=trial.landmarks.retract(delta_l))
        H_t, g_t, H_ll_t, g_l_t, W_t, new_cost = assemble(trial, families,
                                                          losses)
        accept = ok & (new_cost < cost) & active
        window = win.where(accept, trial, window)
        H, g = sel(accept, H_t, H), sel(accept, g_t, g)
        H_ll, g_l = sel(accept, H_ll_t, H_ll), sel(accept, g_l_t, g_l)
        W = sel(accept, W_t, W)
        rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        done = done | (accept & (rel_drop < options.function_tolerance))
        lam = torch.where(
            ~active | done, lam,
            torch.where(accept,
                        torch.clamp(lam * 0.5, min=options.min_lambda),
                        torch.clamp(lam * 4.0, max=options.max_lambda)))
        cost = torch.where(accept, new_cost, cost)
    return window, init_cost, cost

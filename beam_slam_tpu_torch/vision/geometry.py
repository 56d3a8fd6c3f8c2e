"""Multi-view geometry on tensors: triangulation, essential-matrix RANSAC,
PnP pose refinement (port of :mod:`beam_slam_tpu.vision.geometry`).

The beam_cv utilities the reference drives (SURVEY.md §1 L0):
``Triangulation::TriangulatePoint`` (visual_odometry.cpp TriangulateLandmark
:532), the essential-matrix RANSAC outlier gate on incoming tracks
(visual_odometry.cpp:516-527), and ``PoseRefinement::RefinePose`` (the
Ceres PnP refine in LocalizeFrame :217). Everything runs on the inputs'
device; SfM initialization (:mod:`beam_slam_tpu_torch.vision.sfm`) calls
them.

RANSAC is batched hypothesis scoring — all M minimal samples are solved and
scored at once (masks instead of early exit). Its samples are handed in as
indices or drawn from a generator seeded 1: torch cannot redraw the
reference's ``jax.random`` samples, so a parity test passes the indices the
reference drew. The PnP refine's Jacobian is the closed-form reprojection
chain (as in :mod:`beam_slam_tpu_torch.vision.geometry_np`); the reference
differentiates the same residual with ``jacfwd`` at δ = 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from beam_slam_tpu_torch.core import lie


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


def triangulate_dlt(q_wc1, p_wc1, q_wc2, p_wc2, ray1, ray2):
    """Two-view midpoint/DLT triangulation from bearing rays.

    q/p: world-from-camera poses; ray: unit bearings in each camera frame
    (backprojected, undistorted). Batched over leading dims.
    Returns (X_w, valid) — valid requires positive depth in both views and a
    non-degenerate baseline/parallax.
    """
    d1 = lie.quat_rotate(q_wc1, ray1)
    d2 = lie.quat_rotate(q_wc2, ray2)
    # closed-form midpoint: solve [d1 -d2][t1 t2]ᵀ = p2 - p1 in lstsq sense
    b = p_wc2 - p_wc1
    d11 = torch.sum(d1 * d1, dim=-1)
    d22 = torch.sum(d2 * d2, dim=-1)
    d12 = torch.sum(d1 * d2, dim=-1)
    denom = d11 * d22 - d12 * d12
    bd1 = torch.sum(b * d1, dim=-1)
    bd2 = torch.sum(b * d2, dim=-1)
    denom_safe = torch.where(denom.abs() < 1e-9,
                             torch.full_like(denom, 1e-9), denom)
    t1 = (bd1 * d22 - bd2 * d12) / denom_safe
    t2 = (bd1 * d12 - bd2 * d11) / denom_safe
    X1 = p_wc1 + t1[..., None] * d1
    X2 = p_wc2 + t2[..., None] * d2
    X = 0.5 * (X1 + X2)
    parallax_ok = denom.abs() > 1e-6
    valid = (t1 > 1e-3) & (t2 > 1e-3) & parallax_ok
    return X, valid


def triangulation_reprojection_gate(q_wc, p_wc, intr4, X_w, uv, max_px):
    """Reprojection sanity check used after triangulation (the reference
    validates new landmarks by reprojection error)."""
    X_c = lie.quat_rotate(lie.quat_conj(q_wc), X_w - p_wc)
    z = torch.clamp(X_c[..., 2], min=1e-6)
    u = intr4[..., 0] * X_c[..., 0] / z + intr4[..., 2]
    v = intr4[..., 1] * X_c[..., 1] / z + intr4[..., 3]
    err = torch.linalg.vector_norm(torch.stack([u, v], dim=-1) - uv, dim=-1)
    return (err < max_px) & (X_c[..., 2] > 1e-3)


# ---------------------------------------------------------------------------
# Essential matrix RANSAC (8-point, batched hypotheses)
# ---------------------------------------------------------------------------


class RansacResult(NamedTuple):
    E: torch.Tensor        # [3, 3] best essential matrix
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor
    best_score: torch.Tensor


def ransac_samples(valid: torch.Tensor, n_hypotheses: int) -> torch.Tensor:
    """The minimal samples: [n_hypotheses, 8] indices drawn with replacement,
    each index with weight valid + 1e-6 (the reference's sampling weights),
    from a CPU generator seeded 1."""
    w = valid.to(torch.float32).cpu() + 1e-6
    idx = torch.multinomial(w, n_hypotheses * 8, replacement=True,
                            generator=torch.Generator().manual_seed(1))
    return idx.reshape(n_hypotheses, 8).to(valid.device)


def essential_ransac(xn1: torch.Tensor, xn2: torch.Tensor,
                     valid: torch.Tensor, n_hypotheses: int = 128,
                     threshold: float = 2e-3,
                     idx: Optional[torch.Tensor] = None) -> RansacResult:
    """8-point essential RANSAC on *normalized* image coordinates.

    xn1/xn2: [N, 2] normalized coords ((u-cx)/fx) in frames 1/2; valid: [N].
    ``idx`` [n_hypotheses, 8] gives the minimal samples; without it they are
    drawn by :func:`ransac_samples`. All hypotheses are
    solved and Sampson-scored at once; the first of the best scores wins.
    """
    N = xn1.shape[0]
    if idx is None:
        idx = ransac_samples(valid, n_hypotheses)
    idx = idx.to(xn1.device)
    ones = torch.ones((N, 1), dtype=xn1.dtype, device=xn1.device)
    h1 = torch.cat([xn1, ones], dim=1)
    h2 = torch.cat([xn2, ones], dim=1)

    a = h1[idx]   # [M, 8, 3]
    b = h2[idx]
    # rows: kron(b_i, a_i): E such that b_iᵀ E a_i = 0  → A·vec(E) = 0
    A = torch.einsum("mni,mnj->mnij", b, a).reshape(-1, 8, 9)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    E = Vt[:, -1].reshape(-1, 3, 3)
    # rank-2 projection
    U, S, Vt2 = torch.linalg.svd(E)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    Es = (U * S[:, None, :]) @ Vt2           # [M, 3, 3]

    Ea = torch.einsum("mij,nj->mni", Es, h1)       # [M, N, 3]
    Etb = torch.einsum("mji,nj->mni", Es, h2)
    num = torch.einsum("ni,mni->mn", h2, Ea) ** 2
    den = (Ea[..., 0] ** 2 + Ea[..., 1] ** 2
           + Etb[..., 0] ** 2 + Etb[..., 1] ** 2)
    d = num / torch.clamp(den, min=1e-12)    # [M, N]
    inl = (d < threshold * threshold) & valid[None, :]
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores)
    return RansacResult(E=Es[best], inliers=inl[best],
                        n_inliers=scores[best], best_score=scores[best])


# ---------------------------------------------------------------------------
# PnP refinement (RefinePose equivalent)
# ---------------------------------------------------------------------------


class PnPResult(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    information: torch.Tensor   # [6, 6] (JᵀWJ), tangent order [dθ, dp]
    mean_error_px: torch.Tensor
    n_inliers: torch.Tensor
    converged: torch.Tensor


def _project(q, p, X_w, intr4):
    """World points into the camera (q, p): (X_c [N, 3], z, uv [N, 2])."""
    X_c = lie.quat_rotate(lie.quat_conj(q)[None, :], X_w - p[None, :])
    z = torch.clamp(X_c[:, 2], min=1e-3)
    u = intr4[0] * X_c[:, 0] / z + intr4[2]
    v = intr4[1] * X_c[:, 1] / z + intr4[3]
    return X_c, z, torch.stack([u, v], dim=-1)


def refine_pose(q0, p0, X_w, uv, intr4, valid, iterations: int = 10,
                huber_px: float = 3.0, min_inliers: int = 10) -> PnPResult:
    """GN refinement of a world-from-camera pose against 2D-3D pairs
    (pose_refiner_->RefinePose, visual_odometry.cpp LocalizeFrame :217).

    X_w [N,3], uv [N,2] undistorted pixels, intr4 = [fx, fy, cx, cy].
    Huber-reweighted; fixed iterations; masked. A step that is not finite
    is dropped (the pose stays), and the result is then not converged.
    """
    dtype, dev = uv.dtype, uv.device
    intr4 = torch.as_tensor(intr4, dtype=dtype, device=dev)
    fx, fy = intr4[0], intr4[1]
    q, p = q0.to(dtype), p0.to(dtype)
    vmask = valid.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    H = eye6
    okd = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        X_c, z, uv_hat = _project(q, p, X_w, intr4)
        r = uv_hat - uv                                   # [N, 2]
        en = torch.linalg.vector_norm(r, dim=1)
        w = torch.where(en <= huber_px, torch.ones_like(en),
                        huber_px / torch.clamp(en, min=1e-9)) * vmask
        # the projection's Jacobian in X_c (zero in z where z is clamped,
        # as autodiff of the clamp gives), chained to the right-perturbed
        # pose: ∂X_c/∂dθ = [X_c]×, ∂X_c/∂dp = -Rᵀ
        inv_z = 1.0 / z
        live = (X_c[:, 2] > 1e-3).to(dtype)
        zero = torch.zeros_like(z)
        A = torch.stack([
            torch.stack([fx * inv_z, zero,
                         -fx * X_c[:, 0] * inv_z * inv_z * live], dim=-1),
            torch.stack([zero, fy * inv_z,
                         -fy * X_c[:, 1] * inv_z * inv_z * live], dim=-1),
        ], dim=-2)                                        # [N, 2, 3]
        Rt = lie.quat_to_matrix(q).T
        J = torch.cat([A @ lie.skew(X_c), -(A @ Rt)], dim=2)   # [N, 2, 6]
        Jf = J.reshape(-1, 6)
        w2 = w.repeat_interleave(2)
        H = Jf.T @ (Jf * w2[:, None]) + 1e-6 * eye6
        g = -Jf.T @ (r.reshape(-1) * w2)
        delta = torch.linalg.solve(H, g)
        okd = torch.all(torch.isfinite(delta))
        delta = torch.where(okd, delta, torch.zeros_like(delta))
        q = lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
        p = p + delta[3:6]
    _, _, uv_hat = _project(q, p, X_w, intr4)
    en = torch.linalg.vector_norm(uv_hat - uv, dim=1)
    inl = valid & (en < 2 * huber_px)
    n_inl = torch.sum(inl)
    mean_err = torch.sum(en * inl) / torch.clamp(n_inl, min=1)
    return PnPResult(q=q, p=p, information=H, mean_error_px=mean_err,
                     n_inliers=n_inl.to(torch.int32),
                     converged=(n_inl >= min_inliers) & okd)

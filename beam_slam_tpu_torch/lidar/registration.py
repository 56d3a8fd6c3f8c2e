"""LOAM scan-to-map registration by Gauss–Newton on the 6-dof pose (port of
:mod:`beam_slam_tpu.lidar.registration`).

Point-to-line residuals on edge features and point-to-plane residuals on
surface features against a world-frame feature map. Correspondences come
from brute-force kNN (``ops.knn.knn_topk``, kernel K2 on the card) or, in
``corr_mode="radius"``, from fixed-radius neighbourhood moments
(``ops.moments.radius_moments``, kernel K3 on the card); line and plane fits
are closed-form batched math (power iteration on 3×3 scatters); each GN
step solves a 6×6 system from a ``torch.func.jacfwd`` Jacobian.

Eager control flow in place of ``lax.cond`` / ``lax.scan``: the adaptive
refit schedule decides on the host whether the pose has moved enough to
refit the correspondences, which costs one host sync per GN step after the
first (``iterations − 1`` per registration). Everything else stays on the
device of the inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.autodiff import FORWARD_AD
from beam_slam_tpu_torch.device import to_device
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud
from beam_slam_tpu_torch.ops import knn as knn_ops
from beam_slam_tpu_torch.ops import moments as moment_ops


class LoamRegistrationConfig(NamedTuple):
    # Total GN step budget. corr_refits=0 runs the ADAPTIVE schedule: the
    # correspondences (kNN + line/plane fits, the expensive stage) are refit
    # whenever the pose has moved more than refit_rot_tol / refit_trans_tol
    # since the last fit, and reused otherwise. corr_refits>0 is the fixed
    # schedule: that many fits, each followed by ceil(iterations/corr_refits)
    # fixed-correspondence steps.
    iterations: int = 8
    corr_refits: int = 0
    refit_rot_tol: float = 0.0035
    refit_trans_tol: float = 0.005
    k_edge: int = 5
    # large enough to reach across scan rings (same-ring neighbours are
    # collinear and leave the plane normal free)
    k_surf: int = 10
    max_corr_dist: float = 1.0         # correspondence gate (m)
    edge_eig_ratio_min: float = 3.0    # λ1/λ2 gate for valid line fit
    plane_fit_tol: float = 0.1         # max |residual| of plane fit points (m)
    # rank-2 gate: 2nd principal scatter eigenvalue over the 1st
    plane_planarity_min: float = 0.02
    min_inliers: int = 20
    # per-iteration trust region (rad / m)
    max_rot_step: float = 0.1
    max_trans_step: float = 0.5
    # correspondence search: "knn" (gather top-k + neighbour fits) or
    # "radius" (fixed-radius neighbourhood moments)
    corr_mode: str = "knn"
    edge_radius: float = 0.35
    surf_radius: float = 0.3
    radius_min_neighbors: int = 5
    # rms point-plane gate for radius mode (λ₃/n)
    plane_rms_tol: float = 0.03


class RegistrationResult(NamedTuple):
    q: torch.Tensor              # [4] refined T_MAP_SCAN rotation
    p: torch.Tensor              # [3] refined translation
    information: torch.Tensor    # [6, 6] GN information JᵀWJ, order [dθ, dp]
    mean_residual: torch.Tensor  # [] mean |inlier residual|
    n_inliers: torch.Tensor      # [] int32
    converged: torch.Tensor      # [] bool (enough inliers & finite solve)


def _knn(query, q_valid, ref, ref_valid, k: int):
    """Brute-force kNN: (idx [Nq,k], d2 [Nq,k]), invalid refs at +inf."""
    del q_valid  # every query row is searched; the weights mask them later
    return knn_ops.knn_topk(query.contiguous(), ref.contiguous(),
                            ref_valid.contiguous(), k)


def _radius_moments(query, ref, ref_valid, rad: float):
    """(n, centroid, centred scatter) of each query's radius-``rad``
    neighbourhood among the valid refs."""
    return moment_ops.radius_moments(query.contiguous(), ref.contiguous(),
                                     ref_valid.contiguous(), rad)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A constant vector on ``like``'s device, copied from pinned memory
    without waiting: ``torch.tensor(values, device=cuda)`` or an element
    write would be a pageable copy, which waits for the device."""
    return to_device(np.asarray(values, np.float32), like.device).to(
        like.dtype)


def _normalized(d: torch.Tensor) -> torch.Tensor:
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                           min=1e-9)


def _trace(S: torch.Tensor) -> torch.Tensor:
    return S.diagonal(dim1=1, dim2=2).sum(-1)


def _principal_dirs(S, c):
    """Top-2 principal directions + eigenvalues of per-point 3×3 scatters
    (shifted power iteration + deflation)."""
    d1 = _vec([1.0, 0.0, 0.0], S).expand(c.shape) + 0.01 * c
    for _ in range(4):
        d1 = _normalized(torch.einsum("nij,nj->ni", S, d1))
    lam1 = torch.einsum("ni,nij,nj->n", d1, S, d1)
    S2 = S - lam1[:, None, None] * (d1[:, :, None] * d1[:, None, :])
    d2v = lie._cross(d1, _vec([0.577, 0.577, 0.578], S))
    for _ in range(4):
        d2v = _normalized(torch.einsum("nij,nj->ni", S2, d2v))
    lam2 = torch.einsum("ni,nij,nj->n", d2v, S2, d2v)
    return d1, lam1, d2v, lam2


def _neighbour_scatter(pts_map, map_pts, map_valid, k: int):
    """kNN neighbourhoods: (neighbours [N,k,3], all-valid [N], nearest d2
    [N], centroid [N,3], centred scatter [N,3,3])."""
    idx, d2 = _knn(pts_map, None, map_pts, map_valid, k)
    nb = map_pts[idx]                                # [N, k, 3]
    nb_ok = (map_valid[idx] & torch.isfinite(d2)).all(dim=1)
    centroid = nb.mean(dim=1)
    X = nb - centroid[:, None, :]
    S = torch.einsum("nki,nkj->nij", X, X)
    return nb, nb_ok, d2[:, 0], centroid, S


def _edge_residuals(pts_map, pts_valid, map_edges, map_valid,
                    cfg: LoamRegistrationConfig):
    """Line fit to the kNN of each (map-frame) scan edge point: (centroid,
    direction, weight), held fixed for the GN steps that follow."""
    _, nb_ok, d2_0, centroid, S = _neighbour_scatter(
        pts_map, map_edges, map_valid, cfg.k_edge)
    d = _vec([1.0, 0.0, 0.0], S).expand(centroid.shape) + 0.01 * centroid
    for _ in range(4):
        d = _normalized(torch.einsum("nij,nj->ni", S, d))
    lam1 = torch.einsum("ni,nij,nj->n", d, S, d)
    lam_rest = 0.5 * (_trace(S) - lam1)
    line_ok = lam1 > cfg.edge_eig_ratio_min * torch.clamp(lam_rest, min=1e-9)

    # non-finite fits must contribute exactly zero (NaN·0 = NaN)
    finite = (torch.isfinite(centroid).all(dim=1)
              & torch.isfinite(d).all(dim=1))
    centroid = torch.where(finite[:, None], centroid,
                           torch.zeros_like(centroid))
    d = torch.where(finite[:, None], d, _vec([1.0, 0.0, 0.0], d))
    w = (pts_valid & line_ok & finite & nb_ok
         & (d2_0 < cfg.max_corr_dist ** 2))
    return centroid, d, w


def _plane_from_dirs(d1, d2v, c, planar):
    """Unit normal ⊥ the two principal directions and the offset of the
    plane n·x + offset = 0 through c; non-finite fits sanitised."""
    n_raw = lie._cross(d1, d2v)
    n_hat = n_raw / torch.clamp(
        torch.linalg.vector_norm(n_raw, dim=1, keepdim=True), min=1e-9)
    offset = -torch.einsum("ni,ni->n", n_hat, c)
    finite = (torch.isfinite(n_hat).all(dim=1) & torch.isfinite(offset)
              & planar)
    n_hat = torch.where(finite[:, None], n_hat, _vec([0.0, 0.0, 1.0], n_hat))
    offset = torch.where(finite, offset, torch.zeros_like(offset))
    return n_hat, offset, finite


def _plane_residuals(pts_map, pts_valid, map_surfs, map_valid,
                     cfg: LoamRegistrationConfig):
    """Plane fit to the kNN of each scan surface point: (unit normal,
    offset, weight) with the plane as n·x + offset = 0. The normal comes
    from the centred neighbour scatter, which is invariant to the patch's
    distance from the origin."""
    nb, nb_ok, d2_0, centroid, S = _neighbour_scatter(
        pts_map, map_surfs, map_valid, cfg.k_surf)
    d1, lam1, d2v, lam2 = _principal_dirs(S, centroid)
    planar = lam2 > cfg.plane_planarity_min * torch.clamp(lam1, min=1e-9)
    n_hat, offset, finite = _plane_from_dirs(d1, d2v, centroid, planar)
    # fit quality: every neighbour close to the plane
    fit_res = torch.abs(torch.einsum("nki,ni->nk", nb, n_hat)
                        + offset[:, None])
    plane_ok = (fit_res < cfg.plane_fit_tol).all(dim=1)
    w = (pts_valid & plane_ok & finite & nb_ok
         & (d2_0 < cfg.max_corr_dist ** 2))
    return n_hat, offset, w


def _edge_residuals_radius(pts_map, pts_valid, map_edges, map_valid,
                           cfg: LoamRegistrationConfig):
    """Line fit from fixed-radius neighbourhood moments."""
    n, c, S = _radius_moments(pts_map, map_edges, map_valid, cfg.edge_radius)
    d1, lam1, _, _ = _principal_dirs(S, c)
    lam_rest = 0.5 * torch.clamp(_trace(S) - lam1, min=0.0)
    line_ok = lam1 > cfg.edge_eig_ratio_min * torch.clamp(lam_rest, min=1e-9)
    finite = torch.isfinite(c).all(dim=1) & torch.isfinite(d1).all(dim=1)
    c = torch.where(finite[:, None], c, torch.zeros_like(c))
    d1 = torch.where(finite[:, None], d1, _vec([1.0, 0.0, 0.0], d1))
    w = pts_valid & line_ok & finite & (n >= cfg.radius_min_neighbors)
    return c, d1, w


def _plane_residuals_radius(pts_map, pts_valid, map_surfs, map_valid,
                            cfg: LoamRegistrationConfig):
    """Plane fit from fixed-radius neighbourhood moments; fit quality from
    the smallest scatter eigenvalue (rms point-plane distance² = λ₃/n)."""
    n, c, S = _radius_moments(pts_map, map_surfs, map_valid, cfg.surf_radius)
    d1, lam1, d2v, lam2 = _principal_dirs(S, c)
    planar = lam2 > cfg.plane_planarity_min * torch.clamp(lam1, min=1e-9)
    n_hat, offset, finite = _plane_from_dirs(d1, d2v, c, planar)
    lam3 = torch.clamp(_trace(S) - lam1 - lam2, min=0.0)
    rms2 = lam3 / torch.clamp(n, min=1.0)
    flat_ok = rms2 < cfg.plane_rms_tol ** 2
    w = (pts_valid & flat_ok & finite & planar
         & (n >= cfg.radius_min_neighbors))
    return n_hat, offset, w


Corr = Tuple[torch.Tensor, ...]  # (centroid, dir, w_e, normal, offset, w_s)


def _fit_corr(q, p, edges, edges_valid, surfs, surfs_valid, map_edges,
              map_edges_valid, map_surfs, map_surfs_valid,
              cfg: LoamRegistrationConfig) -> Corr:
    """Correspondence fit at the current estimate (the expensive stage:
    two neighbour searches + line/plane fits)."""
    e_map = lie.quat_rotate(q[None, :], edges) + p[None, :]
    s_map = lie.quat_rotate(q[None, :], surfs) + p[None, :]
    if cfg.corr_mode == "radius":
        cen, dirs, w_e = _edge_residuals_radius(
            e_map, edges_valid, map_edges, map_edges_valid, cfg)
        n_hat, off, w_s = _plane_residuals_radius(
            s_map, surfs_valid, map_surfs, map_surfs_valid, cfg)
    else:
        cen, dirs, w_e = _edge_residuals(e_map, edges_valid, map_edges,
                                         map_edges_valid, cfg)
        n_hat, off, w_s = _plane_residuals(s_map, surfs_valid, map_surfs,
                                           map_surfs_valid, cfg)
    return cen, dirs, w_e, n_hat, off, w_s


def _gn_step(q, p, corr: Corr, edges, surfs, cfg: LoamRegistrationConfig):
    """One fixed-correspondence GN step: ((q, p), (H, n_in, mean_r, ok))."""
    cen, dirs, w_e, n_hat, off, w_s = corr
    n_in = w_e.sum() + w_s.sum()
    w_e = w_e.to(edges.dtype)
    w_s = w_s.to(surfs.dtype)

    def residuals(delta):
        q_new = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
        p_new = p + delta[3:6]
        e = lie.quat_rotate(q_new[None, :], edges) + p_new[None, :]
        s = lie.quat_rotate(q_new[None, :], surfs) + p_new[None, :]
        # point-to-line distance, eps-guarded: the plain norm has a NaN
        # derivative where the cross product is exactly zero
        cr = lie._cross(e - cen, dirs)
        r_e = torch.sqrt(torch.sum(cr * cr, dim=1) + 1e-12)
        r_s = torch.einsum("ni,ni->n", s, n_hat) + off  # point-to-plane
        return torch.cat([r_e * w_e, r_s * w_s])

    delta0 = torch.zeros(6, dtype=edges.dtype, device=edges.device)
    r = residuals(delta0)
    with FORWARD_AD:   # the smoother's worker runs forward AD too
        J = jacfwd(residuals)(delta0)
    H = J.T @ J
    g = -J.T @ r
    Hd = H + 1e-4 * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = torch.linalg.solve_ex(Hd, g)[0]  # no host sync (solve checks)
    ok = torch.isfinite(delta).all()
    delta = torch.where(ok, delta, torch.zeros_like(delta))
    # trust region: clamp rotation / translation step norms ...
    rot_n = torch.linalg.vector_norm(delta[0:3])
    tr_n = torch.linalg.vector_norm(delta[3:6])
    delta = torch.cat([
        delta[0:3] * torch.clamp(
            cfg.max_rot_step / torch.clamp(rot_n, min=1e-12), max=1.0),
        delta[3:6] * torch.clamp(
            cfg.max_trans_step / torch.clamp(tr_n, min=1e-12), max=1.0)])
    # ... and reject any step that raises the fixed-correspondence cost
    cost0 = torch.sum(r * r)
    cost1 = torch.sum(residuals(delta) ** 2)
    accept = ok & (cost1 < cost0)
    delta = torch.where(accept, delta, torch.zeros_like(delta))
    q_new = lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
    p_new = p + delta[3:6]
    mean_r = torch.sum(torch.abs(r)) / torch.clamp(n_in, min=1)
    return (q_new, p_new), (H, n_in, mean_r, ok)


def register_loam(scan: FeatureCloud, map_edges, map_edges_valid,
                  map_surfs, map_surfs_valid, q0, p0,
                  cfg: LoamRegistrationConfig = LoamRegistrationConfig()
                  ) -> RegistrationResult:
    """Refine T_MAP_SCAN = (q, p) from the initial guess (q0, p0).

    ``scan`` features are in the scan frame, on the device of the map
    tensors; maps are world/map-frame point sets (strong + weak features
    concatenated by the caller). Scan side: strong edges only (weak scan
    "edges" are often ring-arc artefacts whose line fits creep the
    solution), all surfaces.
    """
    edges = torch.cat([scan.edge_strong, scan.edge_weak], dim=0)
    edges_valid = torch.cat([scan.edge_strong_valid,
                             torch.zeros_like(scan.edge_weak_valid)], dim=0)
    surfs = torch.cat([scan.surf_strong, scan.surf_weak], dim=0)
    surfs_valid = torch.cat([scan.surf_strong_valid, scan.surf_weak_valid],
                            dim=0)
    dtype, device = edges.dtype, edges.device
    q = torch.as_tensor(q0, dtype=dtype, device=device)
    p = torch.as_tensor(p0, dtype=dtype, device=device)

    def fit(q, p):
        return _fit_corr(q, p, edges, edges_valid, surfs, surfs_valid,
                         map_edges, map_edges_valid, map_surfs,
                         map_surfs_valid, cfg)

    adaptive = (cfg.corr_refits == 0
                and (cfg.refit_rot_tol > 0 or cfg.refit_trans_tol > 0))
    if adaptive:
        # movement-gated refit: the neighbour search and fits run only when
        # the pose moved enough since the last fit to change assignments
        corr, q_ref, p_ref = fit(q, p), q, p
        for step in range(cfg.iterations):
            if step > 0:  # at step 0 the pose is the last fit's pose
                dq_m = lie.quat_mul(lie.quat_conj(q_ref), q)
                moved = ((torch.linalg.vector_norm(lie.so3_log(dq_m))
                          > cfg.refit_rot_tol)
                         | (torch.linalg.vector_norm(p - p_ref)
                            > cfg.refit_trans_tol))
                if bool(moved):  # host sync: the lax.cond of the reference
                    corr, q_ref, p_ref = fit(q, p), q, p
            (q, p), (H, n_in, mean_r, ok) = _gn_step(q, p, corr, edges,
                                                     surfs, cfg)
    else:
        refits = max(1, min(cfg.corr_refits or cfg.iterations,
                            cfg.iterations))
        inner_steps = -(-cfg.iterations // refits)  # ceil
        for _ in range(refits):
            corr = fit(q, p)
            for _ in range(inner_steps):
                (q, p), (H, n_in, mean_r, ok) = _gn_step(q, p, corr, edges,
                                                         surfs, cfg)
    converged = (n_in >= cfg.min_inliers) & ok
    return RegistrationResult(q=q, p=p, information=H, mean_residual=mean_r,
                              n_inliers=n_in.to(torch.int32),
                              converged=converged)


def sqrt_info_from_information(H: torch.Tensor, scale: float = 1.0,
                               floor: float = 1e-4) -> torch.Tensor:
    """Whitener A with AᵀA = scale·H for relative-pose factors; floor·I if H
    is not SPD."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(scale * H + 1e-9 * eye)
    A = L.transpose(-1, -2)
    ok = (info == 0) & torch.isfinite(A).all()
    return torch.where(ok, A, floor * eye)

"""General point-cloud matchers: ICP (point-to-point), GICP-style
(point-to-plane) and NDT-style (voxel Gaussian) registration (port of
:mod:`beam_slam_tpu.lidar.matchers`).

The reference's MultiScanRegistration supports matcher variants ICP / GICP /
NDT / LOAM through libbeam's ``beam_matching::Matchers.h``
(multi_scan_registration.h:18-139). The LOAM matcher lives in
:mod:`beam_slam_tpu_torch.lidar.registration`; this module holds the
non-feature-based variants with the same recipe: correspondences from the
exact kNN (``ops.knn.knn_topk``, kernel K2 on the card), batched closed-form
fits, a fixed number of Gauss–Newton steps with masked weights.

Each GN step is eager: one ``torch.func.jacfwd`` of the residual, the 6×6
solve with 1e-4 damping, the step clamps and the cost-decrease gate, all on
the device of the inputs and without a host wait.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.autodiff import FORWARD_AD
from beam_slam_tpu_torch.device import to_device
from beam_slam_tpu_torch.ops import knn as knn_ops


class MatcherConfig(NamedTuple):
    iterations: int = 10
    max_corr_dist: float = 1.0
    k_normal: int = 8          # neighbours for normal estimation (GICP)
    min_inliers: int = 30
    huber_delta: float = 0.5
    max_rot_step: float = 0.2
    max_trans_step: float = 1.0


class MatchResult(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    information: torch.Tensor
    mean_residual: torch.Tensor
    n_inliers: torch.Tensor
    converged: torch.Tensor


def _knn(query, ref, ref_valid, k):
    return knn_ops.knn_topk(query.contiguous(), ref.contiguous(),
                            ref_valid.contiguous(), k)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant on ``like``'s device, copied without waiting for it."""
    return to_device(np.asarray(values), like.device).to(like.dtype)


def _normalized(d: torch.Tensor) -> torch.Tensor:
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                           min=1e-9)


def _gn_register(src, src_valid, residual_geom_fn, q0, p0,
                 cfg: MatcherConfig) -> MatchResult:
    """Shared fixed-iteration GN loop. ``residual_geom_fn(pts_world,
    valid)`` returns a residual closure maker and per-residual weights."""
    dtype, device = src.dtype, src.device
    q = torch.as_tensor(q0, dtype=dtype, device=device)
    p = torch.as_tensor(p0, dtype=dtype, device=device)
    eye = torch.eye(6, dtype=dtype, device=device)
    for _ in range(cfg.iterations):
        world = lie.quat_rotate(q[None, :], src) + p[None, :]
        make_res, w = residual_geom_fn(world, src_valid)

        def residuals(delta, q=q, p=p, make_res=make_res, w=w):
            q_new = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
            p_new = p + delta[3:6]
            pts = lie.quat_rotate(q_new[None, :], src) + p_new[None, :]
            r = make_res(pts)
            # Huber via sqrt-weight, inside the residual so that the
            # Jacobian differentiates through it
            a = torch.abs(r)
            hw = torch.where(a <= cfg.huber_delta, torch.ones_like(a),
                             cfg.huber_delta / torch.clamp(a, min=1e-9))
            return r * torch.sqrt(hw) * w

        d0 = torch.zeros(6, dtype=dtype, device=device)
        r = residuals(d0)
        with FORWARD_AD:   # the smoother's worker runs forward AD too
            J = jacfwd(residuals)(d0)
        H = J.T @ J + 1e-4 * eye
        delta = torch.linalg.solve_ex(H, -J.T @ r)[0]  # no host sync
        ok = torch.isfinite(delta).all()
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        rn = torch.linalg.vector_norm(delta[0:3])
        tn = torch.linalg.vector_norm(delta[3:6])
        delta = torch.cat([
            delta[0:3] * torch.clamp(
                cfg.max_rot_step / torch.clamp(rn, min=1e-12), max=1.0),
            delta[3:6] * torch.clamp(
                cfg.max_trans_step / torch.clamp(tn, min=1e-12), max=1.0)])
        cost0 = torch.sum(r * r)
        cost1 = torch.sum(residuals(delta) ** 2)
        delta = torch.where(ok & (cost1 < cost0), delta,
                            torch.zeros_like(delta))
        q = lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
        p = p + delta[3:6]
        n_in = torch.sum(w > 0)
        mean_r = torch.sum(torch.abs(r)) / torch.clamp(n_in, min=1)
    return MatchResult(q=q, p=p, information=H, mean_residual=mean_r,
                       n_inliers=n_in.to(torch.int32),
                       converged=(n_in >= cfg.min_inliers) & ok)


def icp_point_to_point(src, src_valid, tgt, tgt_valid, q0, p0,
                       cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """Classic ICP: nearest-target-point distance residuals (3 per
    point)."""

    def geom(world, valid):
        idx, d2 = _knn(world, tgt, tgt_valid, 1)
        nn = tgt[idx[:, 0]]
        w = (valid & (d2[:, 0] < cfg.max_corr_dist ** 2)
             & torch.isfinite(d2[:, 0])).to(world.dtype)

        def make_res(pts):
            return (pts - nn).reshape(-1)

        return make_res, w.repeat_interleave(3)

    return _gn_register(src, src_valid, geom, q0, p0, cfg)


def ndt_voxel_gaussian(src, src_valid, tgt, tgt_valid, q0, p0,
                       cfg: MatcherConfig = MatcherConfig(),
                       voxel: float = 1.0,
                       grid_dims=(40, 40, 16)) -> MatchResult:
    """NDT-style registration: the target is modelled as per-voxel Gaussians
    (mean + covariance); each source point is scored by the Mahalanobis
    distance to its voxel's distribution.

    A dense static voxel grid (moments summed with ``index_add_``, batched
    3×3 whitening factors) with point→cell gathers. On the card the sums
    are atomic, so they come out in another order than on the CPU."""
    dtype, device = src.dtype, src.device
    G = grid_dims[0] * grid_dims[1] * grid_dims[2]
    dims = to_device(np.asarray(grid_dims, np.int64), device)

    # grid anchored at the target cloud's min corner
    tgt_safe = torch.where(tgt_valid[:, None], tgt,
                           torch.full_like(tgt, float("inf")))
    origin = torch.amin(tgt_safe, dim=0) - 0.5 * voxel
    origin = torch.where(torch.isfinite(origin), origin,
                         torch.zeros_like(origin))

    def cell_of(pts):
        c = torch.floor((pts - origin) / voxel).to(torch.int64)
        inside = ((c >= 0) & (c < dims)).all(dim=1)
        c = torch.minimum(torch.clamp(c, min=0), dims - 1)
        flat = (c[:, 0] * grid_dims[1] + c[:, 1]) * grid_dims[2] + c[:, 2]
        return flat, inside

    flat_t, inside_t = cell_of(tgt)
    w_t = (tgt_valid & inside_t).to(dtype)
    cnt = torch.zeros(G, dtype=dtype, device=device).index_add_(
        0, flat_t, w_t)
    s1 = torch.zeros((G, 3), dtype=dtype, device=device).index_add_(
        0, flat_t, tgt * w_t[:, None])
    s2 = torch.zeros((G, 3, 3), dtype=dtype, device=device).index_add_(
        0, flat_t, (tgt[:, :, None] * tgt[:, None, :]) * w_t[:, None, None])
    n_safe = torch.clamp(cnt, min=1.0)
    mu = s1 / n_safe[:, None]
    cov = s2 / n_safe[:, None, None] - mu[:, :, None] * mu[:, None, :]
    # regularize: NDT floors the covariance so thin cells stay usable
    cov = cov + (0.05 * voxel) ** 2 * torch.eye(3, dtype=dtype,
                                                device=device)[None]
    occupied = cnt >= 3
    # the reference takes cholesky(inv(cov)) and zeroes the cells where it
    # is not finite; the *_ex forms report those cells instead of raising
    inv, info_inv = torch.linalg.inv_ex(cov)
    L, info = torch.linalg.cholesky_ex(inv)
    good = (info == 0) & (info_inv == 0) & torch.isfinite(L).all(dim=(1, 2))
    L = torch.where(good[:, None, None], L, torch.zeros_like(L))

    def geom(world, valid):
        flat, inside = cell_of(world)
        ok = valid & inside & occupied[flat]
        mu_p = mu[flat]
        L_p = L[flat]
        w = ok.to(dtype)

        def make_res(pts):
            return torch.einsum("nij,nj->ni", L_p, pts - mu_p).reshape(-1)

        return make_res, w.repeat_interleave(3)

    return _gn_register(src, src_valid, geom, q0, p0, cfg)


def gicp_point_to_plane(src, src_valid, tgt, tgt_valid, q0, p0,
                        cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """GICP-style: project the point-to-nearest error onto the local target
    surface normal (plane fit over k neighbours)."""

    def geom(world, valid):
        idx, d2 = _knn(world, tgt, tgt_valid, cfg.k_normal)
        nb = tgt[idx]                              # [N, k, 3]
        centroid = nb.mean(dim=1)
        X = nb - centroid[:, None, :]
        S = torch.einsum("nki,nkj->nij", X, X)
        # normal = smallest eigenvector via two deflated power iterations
        d1 = _const([1.0, 0.0, 0.0], world).expand(centroid.shape) \
            + 0.01 * centroid
        for _ in range(4):
            d1 = _normalized(torch.einsum("nij,nj->ni", S, d1))
        lam1 = torch.einsum("ni,nij,nj->n", d1, S, d1)
        S2 = S - lam1[:, None, None] * (d1[:, :, None] * d1[:, None, :])
        d2v = lie._cross(d1, _const([0.577, 0.577, 0.578], world).expand(
            d1.shape))
        for _ in range(4):
            d2v = _normalized(torch.einsum("nij,nj->ni", S2, d2v))
        normal = _normalized(lie._cross(d1, d2v))
        ok = (valid & (d2[:, 0] < cfg.max_corr_dist ** 2)
              & torch.isfinite(d2[:, 0])
              & torch.isfinite(normal).all(dim=1))
        normal = torch.where(ok[:, None], normal, torch.zeros_like(normal))
        cen = torch.where(ok[:, None], centroid, torch.zeros_like(centroid))
        w = ok.to(world.dtype)

        def make_res(pts):
            return torch.einsum("ni,ni->n", pts - cen, normal)

        return make_res, w

    return _gn_register(src, src_valid, geom, q0, p0, cfg)


def knn_ks(kind: str, cfg: MatcherConfig) -> tuple:
    """The k each matcher asks of the kNN search: ICP 1, GICP
    ``k_normal``, NDT none (its grid needs no search)."""
    return {"ICP": (1,), "GICP": (cfg.k_normal,), "NDT": ()}[kind]

"""SfM-style trajectory bootstrapping from feature tracks (port of
:mod:`beam_slam_tpu.vision.sfm`).

Re-implements ``bs_models::vision::ComputePathWithVision``
(bs_models/src/lib/vision/utils.cpp:12-19 usage; SURVEY.md §2.4): build an
up-to-scale camera path from 2-view epipolar geometry + triangulation + PnP
chaining — the VISUAL mode of SLAMInitialization. Scale is resolved later by
the IMU alignment (estimate_scale=True). The geometry runs on ``device``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.vision import geometry as geo
from beam_slam_tpu_torch.vision.camera import PinholeRadtan

# The essential RANSAC's hypotheses (the reference draws 256 under
# jax.random.PRNGKey(1), sfm.py:94-95).
N_HYPOTHESES = 256


def _unit_rays(xn: torch.Tensor) -> torch.Tensor:
    h = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=1)
    return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)


def decompose_essential(E: torch.Tensor, xn1: torch.Tensor,
                        xn2: torch.Tensor, inliers: torch.Tensor):
    """E → (R, t) with the cheirality test over the four candidates.
    Returns (R_21, t_21, n_good): pose of camera 1 expressed in camera 2
    (x2 ~ R·x1 + t), unit-norm translation."""
    U, S, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    Rs = [U @ W @ Vt, U @ W.T @ Vt]
    ts = [U[:, 2], -U[:, 2]]

    r1, r2 = _unit_rays(xn1), _unit_rays(xn2)
    n = len(r1)
    q_id = lie.quat_identity((n,), dtype=E.dtype, device=E.device)
    zero = torch.zeros((n, 3), dtype=E.dtype, device=E.device)
    # camera1 at origin; camera2 pose: X2 = R X1 + t, so in the world
    # (camera 1's frame) R_wc2 = Rᵀ, p_wc2 = -Rᵀ t
    goods = []
    for R in Rs:
        for t in ts:
            q_wc2 = lie.matrix_to_quat(R.T)
            p_wc2 = -(R.T @ t)
            _, ok = geo.triangulate_dlt(q_id, zero, q_wc2.expand(n, 4),
                                        p_wc2.expand(n, 3), r1, r2)
            goods.append(torch.sum(ok & inliers))
    n_good = to_numpy(torch.stack(goods))[0]
    best = (None, None, -1)
    for k, (R, t) in enumerate((R, t) for R in Rs for t in ts):
        if int(n_good[k]) > best[2]:
            best = (R, t, int(n_good[k]))
    return best


def compute_path_with_vision(
        camera: PinholeRadtan,
        tracks: Dict[int, List[Tuple[float, np.ndarray]]],
        stamps: List[float], min_parallax_px: float = 15.0,
        min_inliers: int = 30, device=None,
        ransac_idx: Optional[Callable[[int, int], np.ndarray]] = None):
    """Up-to-scale baselink-agnostic *camera* path over ``stamps``.

    tracks: id → [(stamp, undistorted pixel)]. Returns
    [(stamp, q_wc, p_wc)] in the first camera's frame with unit baseline
    scale, or None if the geometry is degenerate (insufficient parallax /
    inliers). The geometry runs on ``device`` (the card unless asked
    otherwise). ``ransac_idx(n_points, n_hypotheses)`` gives the essential
    RANSAC's samples ([n_hypotheses, 8] indices); by default they are drawn
    from a generator seeded 1 (:func:`geometry.ransac_samples`).
    """
    device = resolve(device)
    if len(stamps) < 3:
        return None
    t0, t1 = stamps[0], stamps[-1]

    # correspondences first↔last
    ids, uv0s, uv1s = [], [], []
    for lm_id, obs in tracks.items():
        by_t = {t: uv for t, uv in obs}
        if t0 in by_t and t1 in by_t:
            ids.append(lm_id)
            uv0s.append(by_t[t0])
            uv1s.append(by_t[t1])
    if len(ids) < min_inliers:
        return None
    uv0s = np.stack(uv0s)
    uv1s = np.stack(uv1s)
    if np.median(np.linalg.norm(uv1s - uv0s, axis=1)) < min_parallax_px:
        return None

    def as_t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    xn0 = as_t(((uv0s - [cx, cy]) / [fx, fy]).astype(np.float32))
    xn1 = as_t(((uv1s - [cx, cy]) / [fx, fy]).astype(np.float32))
    n = len(ids)
    valid = torch.ones(n, dtype=torch.bool, device=xn0.device)
    idx = (None if ransac_idx is None
           else as_t(ransac_idx(n, N_HYPOTHESES), torch.int64))
    res = geo.essential_ransac(xn0, xn1, valid, N_HYPOTHESES, idx=idx)
    if int(res.n_inliers) < min_inliers:
        return None
    R, t, n_good = decompose_essential(res.E, xn0, xn1, res.inliers)
    if R is None or n_good < min_inliers:
        return None

    # triangulate the inlier landmarks in the first camera's frame
    q_wc1 = lie.matrix_to_quat(R.T)
    p_wc1 = -(R.T @ t)
    X, ok = geo.triangulate_dlt(
        lie.quat_identity((n,), device=xn0.device),
        torch.zeros((n, 3), device=xn0.device),
        q_wc1.expand(n, 4), p_wc1.expand(n, 3), _unit_rays(xn0),
        _unit_rays(xn1))
    X, ok = to_numpy(X, ok & res.inliers)
    lm_world = {lm_id: X[i] for i, lm_id in enumerate(ids) if ok[i]}
    if len(lm_world) < min_inliers:
        return None

    # PnP-chain every stamp against the triangulated structure
    path = []
    q_prev = lie.quat_identity(device=xn0.device)
    p_prev = torch.zeros(3, device=xn0.device)
    intr4 = camera.intr4.to(xn0.device)
    for s in stamps:
        Xs, uvs = [], []
        for lm_id, Xw in lm_world.items():
            by_t = {t: uv for t, uv in tracks[lm_id]}
            if s in by_t:
                Xs.append(Xw)
                uvs.append(by_t[s])
        if len(Xs) < 10:
            return None
        pnp = geo.refine_pose(q_prev, p_prev, as_t(np.stack(Xs)),
                              as_t(np.stack(uvs)), intr4,
                              torch.ones(len(Xs), dtype=torch.bool,
                                         device=xn0.device))
        q, p, converged = to_numpy(pnp.q, pnp.p, pnp.converged)
        if not bool(converged):
            return None
        q_prev, p_prev = pnp.q, pnp.p
        path.append((s, q, p))
    return path

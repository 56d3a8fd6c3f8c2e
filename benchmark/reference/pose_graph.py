"""Plain reference of the pose-graph LM solve, in plain PyTorch.

The same mathematics as the program's single-shard pose-graph solve: the
relative-pose residual ``[log(dq⁻¹ · q_i⁻¹ q_j), R_iᵀ(p_j − p_i) − dp]``
and the absolute prior, whitened by their square-root information;
Jacobians by forward-mode autodiff at δ = 0 under the right retraction
``q ⊗ exp(δθ), p + δp``; dense normal equations, each factor's JᵀJ, Jᵀr
and rᵀr taken from one product (the Gram matrix of [J | r]), so that a
lower precision of products reaches the gradient and the cost as well as
the Hessian; held poses masked to a
unit row; Jacobi equilibration; ``+ λI``; the LM accept test and λ
schedule (λ₀ = 1e-4, ×0.5 on accept down to 1e-12, ×4 on reject up to
1e8); exactly ``n_iter`` steps. The dense solve is :mod:`.dense`. Run in
float64 it is the reference; in float32 with TF32 allowed, the control.

The problem is the plain dict of tensors that :mod:`benchmark.traffic.
pose_graph` makes: ``q [N, 4]``, ``p [N, 3]``, ``free [N]``, the factors
``i, j [F]``, ``dq [F, 4]``, ``dp [F, 3]``, ``sqrt_info [F, 6, 6]``,
``active [F]`` and the priors ``prior_slot``, ``prior_q0``, ``prior_p0``,
``prior_sqrt_info``, ``prior_active``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import lie
from benchmark.reference.dense import cholesky_solve

DOF = 6


def _rel_one(delta, qi, pi, qj, pj, dq, dp, A):
    qi = lie.quat_mul(qi, lie.so3_exp_quat(delta[0:3]))
    qj = lie.quat_mul(qj, lie.so3_exp_quat(delta[6:9]))
    pi, pj = pi + delta[3:6], pj + delta[9:12]
    q_ij = lie.quat_mul(lie.quat_conj(qi), qj)
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(dq), q_ij))
    r_p = lie.quat_rotate(lie.quat_conj(qi), pj - pi) - dp
    r = A @ torch.cat([r_q, r_p])
    return r, r


def _prior_one(delta, q, p, q0, p0, A):
    q = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
    r = A @ torch.cat([r_q, p + delta[3:6] - p0])
    return r, r


def _linearize(fn, n_dof, args):
    zeros = args[0].new_zeros((args[0].shape[0], n_dof))
    J, r = torch.func.vmap(torch.func.jacfwd(fn, has_aux=True))(zeros, *args)
    return r, J


def _scatter(H, g, slots, J, r):
    """H[c, c'] += JᵀJ and g[c] -= Jᵀr for the 6-dof blocks of ``slots``
    [F, k] (one row of pose slots per factor), all three from one product
    per factor: the Gram matrix of the augmented Jacobian [J | r], whose
    corner rᵀr is the factor's squared residual. Returns Σ rᵀr."""
    D = H.shape[-1]
    Jr = torch.cat([J, r[..., None]], dim=-1)
    G = torch.einsum("fri,frj->fij", Jr, Jr)
    k = J.shape[-1]
    cols = (slots[..., None] * DOF
            + torch.arange(DOF, device=slots.device)).reshape(
                slots.shape[0], -1)
    g.index_add_(0, cols.reshape(-1), -G[:, :k, k].reshape(-1))
    H.view(-1).index_add_(0, (cols[:, :, None] * D
                              + cols[:, None, :]).reshape(-1),
                          G[:, :k, :k].reshape(-1))
    return torch.sum(G[:, k, k])


def normal_equations(prob: Dict[str, torch.Tensor], q, p):
    """(H [D, D], g [D], cost) of the whole graph at poses (q, p)."""
    D = q.shape[0] * DOF
    H = q.new_zeros((D, D))
    g = q.new_zeros(D)
    i, j = prob["i"], prob["j"]
    r, J = _linearize(_rel_one, 2 * DOF, (
        q[i], p[i], q[j], p[j], prob["dq"], prob["dp"], prob["sqrt_info"]))
    m = prob["active"].to(q.dtype)
    rr = _scatter(H, g, torch.stack([i, j], -1), J * m[:, None, None],
                  r * m[:, None])
    s = prob["prior_slot"]
    rp, Jp = _linearize(_prior_one, DOF, (
        q[s], p[s], prob["prior_q0"], prob["prior_p0"],
        prob["prior_sqrt_info"]))
    mp = prob["prior_active"].to(q.dtype)
    rr = rr + _scatter(H, g, s[:, None], Jp * mp[:, None, None],
                       rp * mp[:, None])
    return H, g, 0.5 * rr


def cost(prob: Dict[str, torch.Tensor], q, p) -> torch.Tensor:
    """The graph's cost ½‖r‖² at poses (q, p), without Jacobians, in the
    dtype of q."""
    dt = q.dtype
    i, j = prob["i"], prob["j"]
    zero = q.new_zeros(12)
    r = torch.func.vmap(lambda *a: _rel_one(zero, *a)[0])(
        q[i], p[i], q[j], p[j], prob["dq"].to(dt), prob["dp"].to(dt),
        prob["sqrt_info"].to(dt)) * prob["active"].to(dt)[:, None]
    s = prob["prior_slot"]
    rp = torch.func.vmap(lambda *a: _prior_one(zero[:6], *a)[0])(
        q[s], p[s], prob["prior_q0"].to(dt), prob["prior_p0"].to(dt),
        prob["prior_sqrt_info"].to(dt)) * prob["prior_active"].to(dt)[:, None]
    return 0.5 * (torch.sum(r * r) + torch.sum(rp * rp))


def _step(H, g, lam, f):
    """The damped, masked, equilibrated step δ (NaN-free; zero and
    ``ok`` False where the factorization failed)."""
    Hm = H * (f[:, None] * f[None, :])
    Hm.diagonal().add_(1.0 - f)
    s = torch.rsqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
    Hs = Hm * (s[:, None] * s[None, :])
    del Hm
    Hs.diagonal().add_(lam)
    y, ok = cholesky_solve(Hs[None], (g * f * s)[None])
    delta = y[0] * s * f
    ok = ok[0] & torch.isfinite(delta).all()
    return torch.where(ok, delta, torch.zeros_like(delta)), ok


def _retract(q, p, delta, free):
    d = delta.reshape(-1, DOF) * free.to(delta.dtype)[:, None]
    return (lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(d[:, 0:3]))),
            p + d[:, 3:6])


def solve(prob: Dict[str, torch.Tensor], n_iter: int, dtype=torch.float64
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM over the graph for exactly ``n_iter`` steps in ``dtype``. Returns
    (q [N, 4], p [N, 3], initial cost, final cost)."""
    prob = {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in prob.items()}
    q, p = prob["q"], prob["p"]
    f = torch.repeat_interleave(prob["free"], DOF).to(dtype)
    H, g, cost = normal_equations(prob, q, p)
    c0 = cost
    lam = torch.full_like(cost, 1e-4)
    for _ in range(n_iter):
        delta, ok = _step(H, g, lam, f)
        q_t, p_t = _retract(q, p, delta, prob["free"])
        H_t, g_t, c_t = normal_equations(prob, q_t, p_t)
        accept = ok & (c_t < cost)
        q = torch.where(accept, q_t, q)
        p = torch.where(accept, p_t, p)
        H = torch.where(accept, H_t, H)
        g = torch.where(accept, g_t, g)
        cost = torch.where(accept, c_t, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e8))
        del H_t, g_t
    return q, p, c0, cost

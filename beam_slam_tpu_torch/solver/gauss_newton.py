"""Levenberg–Marquardt over the fixed-shape window state, with Schur-
complement elimination of landmarks (port of
:mod:`beam_slam_tpu.solver.gauss_newton`).

  * Every factor family linearizes in one batched pass (closed-form or
    forward-mode Jacobians), producing whitened blocks.
  * The normal equations are scatter-added densely over the window's tangent
    dof (K·15 IMU + E·6 extrinsic + M·6 motion, plus one trailing "trash"
    dof). Landmarks are Schur-eliminated: per-landmark 3×3 blocks H_ll, the
    pose-landmark coupling W, and the reduced camera system
    H_red = H_pp − W·H_ll⁻¹·Wᵀ.
  * Jacobi equilibration makes the reduced system ~unit-diagonal so the
    float32 Cholesky (kernel K1, :mod:`beam_slam_tpu_torch.ops.cholesky`) is
    accurate; landmarks are back-substituted in closed form.
  * The LM loop runs a fixed number of steps with tensor-valued
    accept/reject, damping and an inert ``done`` latch: no ``.item()`` and
    no host sync inside, so a later change can capture it in a CUDA graph.
    With ``SolverOptions.early_exit`` it instead stops once every system's
    ``done`` latch holds, at one host read of ``done`` per step; the steps
    it skips would have been inert, so the result is the same.

Every function below is batch-polymorphic: window leaves, equations and LM
scalars may carry the same leading batch dims. The single-window solve has
none; the shared-topology batched solve (:mod:`.batched`) and the
mixed-topology one (:mod:`beam_slam_tpu_torch.parallel.sharded`, which
assembles with ``per_window``) have ``[B]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from beam_slam_tpu_torch.core import window as win
from beam_slam_tpu_torch.core.window import LANDMARK_DOF, WindowState
from beam_slam_tpu_torch.ops.cholesky import cholesky_solve_batched
from beam_slam_tpu_torch.ops.mat3 import inv3x3

_DIAG_EPS = 1e-12


class SolverOptions(NamedTuple):
    """Solve configuration (the solver_options block of the reference
    configs, beam_slam_launch/config/lvio.yaml:7-17). The loop runs
    ``min(max_iterations, scan_length)`` steps (``scan_length=None``: just
    ``max_iterations``); steps after convergence are inert. ``early_exit``
    stops at convergence instead (the Ceres behaviour: iterate until
    ``function_tolerance``, never past the step cap)."""

    max_iterations: int = 10
    function_tolerance: float = 1e-6
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    scan_length: Optional[int] = None
    early_exit: bool = False


class SolveDiagnostics(NamedTuple):
    """Per-solve diagnostics mirroring the Ceres summary fields."""

    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor   # accepted LM steps
    converged: torch.Tensor    # hit function_tolerance before max_iterations
    final_lambda: torch.Tensor


def robust_weight(sq_norm: torch.Tensor, loss_scale: Optional[float]):
    """IRLS weight + cost for an (optionally Cauchy-robustified) factor.
    Cauchy: ρ(s) = c²·log(1 + s/c²); weight ρ'(s) = 1/(1 + s/c²)."""
    if loss_scale is None:
        return torch.ones_like(sq_norm), sq_norm
    c2 = loss_scale * loss_scale
    w = 1.0 / (1.0 + sq_norm / c2)
    rho = c2 * torch.log1p(sq_norm / c2)
    return w, rho


def _scatter_add(target: torch.Tensor, index: torch.Tensor,
                 values: torch.Tensor, index_lead: int = 0) -> None:
    """target.flatten(over trailing dims)[..., index] += values, in place.

    ``index`` (int64) addresses the trailing ``target.dim() - n_lead`` dims
    flattened; ``values`` has target's leading batch dims followed by
    ``index``'s own shape. ``index`` shared by the batch has no batch dims
    (``index_lead=0``); one index per window carries the ``index_lead``
    leading batch dims, and window b's entries go at an offset of b times
    the window's size in the flat view."""
    n_lead = values.dim() - index.dim() + index_lead
    nb = 1
    for s in target.shape[:n_lead]:
        nb *= s
    if not index_lead:
        target.view(nb, -1).index_add_(1, index.reshape(-1),
                                       values.reshape(nb, -1))
        return
    per = target.numel() // nb
    offset = torch.arange(nb, device=index.device)[:, None] * per
    target.view(-1).index_add_(0, (index.reshape(nb, -1) + offset).reshape(-1),
                               values.reshape(-1))


def _gram(J):
    return torch.einsum("...ri,...rj->...ij", J, J)


def _jtr(J, r):
    return torch.einsum("...ri,...r->...i", J, r)


def assemble_normal_equations(window: WindowState, families: Sequence,
                              losses: Tuple[Optional[float], ...],
                              per_window: bool = False):
    """Linearize every factor family and scatter-add the normal equations.

    Returns (H [...,D+1,D+1], g [...,D+1], H_ll [...,L,3,3], g_l [...,L,3],
    W [...,D+1,L·3], cost [...]). The last dense row/col is a padding
    ("trash") dof. A batch reads its families' shared slots, or with
    ``per_window`` each window's own (a batch of mixed topologies)."""
    lead = window.imu.q.shape[:-2]
    il = len(lead) if per_window else 0
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
        r, J, col, _, lm_slot, J_lm = fam.linearize(window, per_window)
        w, rho = robust_weight(torch.sum(r * r, dim=-1), loss)
        cost = cost + 0.5 * torch.sum(rho, dim=-1)
        sw = torch.sqrt(w)
        r = r * sw[..., None]
        J = J * sw[..., None, None]
        _scatter_add(g, col, -_jtr(J, r), il)
        _scatter_add(H, col[..., :, None] * (D + 1) + col[..., None, :],
                     _gram(J), il)
        if lm_slot is not None:
            J_lm = J_lm * sw[..., None, None]
            lm_cols = lm_slot[..., None] * LANDMARK_DOF + k3   # [..., F, 3]
            _scatter_add(H_ll, lm_cols[..., :, None] * LANDMARK_DOF + k3,
                         _gram(J_lm), il)
            _scatter_add(g_l, lm_cols, -_jtr(J_lm, r), il)
            _scatter_add(W, col[..., :, None] * (L * LANDMARK_DOF)
                         + lm_cols[..., None, :],
                         torch.einsum("...rd,...rc->...dc", J, J_lm), il)
    return H, g, H_ll, g_l, W, cost


# The reference jits this entry point for host callers (exact
# marginalization); eager torch needs no wrapper.
assemble_normal_equations_jit = assemble_normal_equations


def total_cost(window: WindowState, families: Sequence,
               losses: Tuple[Optional[float], ...],
               per_window: bool = False) -> torch.Tensor:
    """Robustified cost only (no Jacobians); ``per_window`` as in
    :func:`assemble_normal_equations`."""
    cost = torch.zeros(window.imu.q.shape[:-2], dtype=window.imu.q.dtype,
                       device=window.imu.q.device)
    for fam, loss in zip(families, losses):
        r = fam.residual_only(window, per_window)
        _, rho = robust_weight(torch.sum(r * r, dim=-1), loss)
        cost = cost + 0.5 * torch.sum(rho, dim=-1)
    return cost


def _damped_reduced_system(H, g, free, lam, H_ll, g_l, W, lm_free):
    """Phase A of the Schur-reduced damped solve: mask, landmark Schur
    complement, Jacobi scaling, damping, 128-padding. Returns the padded
    SPD system (Hp, gp) plus the back-substitution context."""
    dtype, dev = H.dtype, H.device
    Dp = H.shape[-1]
    L = H_ll.shape[-3]
    lead = H.shape[:-2]
    freef = free.to(dtype)
    lmf = lm_free.to(dtype)
    lam = lam[..., None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # mask held/inactive dense dof and landmark slots
    Hm = H * (freef[..., :, None] * freef[..., None, :])
    Hm = Hm + torch.diag_embed(1.0 - freef)
    gm = g * freef
    W = W * freef[..., :, None] * torch.repeat_interleave(
        lmf, LANDMARK_DOF, dim=-1)[..., None, :]
    # damping λ·diag(H_ll) + a trace-relative floor: a landmark seen from a
    # single view has a rank-2 3×3 block whose f32 inverse explodes and makes
    # the Schur complement indefinite; the floor bounds ‖H_ll⁻¹‖ by ~1e5/tr.
    diag_ll = torch.diagonal(H_ll, dim1=-2, dim2=-1)
    tr = torch.sum(diag_ll, dim=-1)
    Hll_d = (H_ll + torch.diag_embed(lam * diag_ll + 1e-8)
             + (1e-5 * tr)[..., None, None] * eye3)
    Hll_d = torch.where(lmf[..., None, None] > 0, Hll_d, eye3)
    g_l = g_l * lmf[..., None]
    Hll_inv = inv3x3(Hll_d)

    # reduced camera system: H_red = H - W·Hll⁻¹·Wᵀ
    Wr = W.reshape(lead + (Dp, L, 3))
    Y = torch.einsum("...dlk,...lkm->...dlm", Wr, Hll_inv)
    H_red = Hm - torch.einsum("...dlm,...elm->...de", Y, Wr)
    g_red = gm - torch.einsum("...dlm,...lm->...d", Y, g_l)

    d = torch.diagonal(H_red, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(d, min=_DIAG_EPS))
    Hs = H_red * (s[..., :, None] * s[..., None, :])
    Hs = Hs + lam * torch.eye(Dp, dtype=dtype, device=dev)
    gs = g_red * s
    # Pad to the next multiple of 128, as the reference does, so Hp/gp match
    # it shape for shape. Padding rows are an identity block (decoupled unit
    # equations): the leading Dp entries of the padded solution are exact.
    pad = (-Dp) % 128
    if pad:
        unit = torch.zeros(Dp + pad, dtype=dtype, device=dev)
        unit[Dp:] = 1.0
        Hp = F.pad(Hs, (0, pad, 0, pad)) + torch.diag(unit)
        gp = F.pad(gs, (0, pad))
    else:
        Hp, gp = Hs, gs
    return Hp, gp, (s, freef, lmf, Hll_inv, Wr, g_l)


def _damped_backsub(y, ctx):
    """Phase B: unscale the reduced solution, back-substitute landmarks."""
    s, freef, lmf, Hll_inv, Wr, g_l = ctx
    Dp = s.shape[-1]
    delta = y[..., :Dp] * s * freef

    # landmark back-substitution: δ_l = Hll⁻¹ (g_l − Wᵀ δ_p)
    rhs_l = g_l - torch.einsum("...dlk,...d->...lk", Wr, delta)
    delta_l = torch.einsum("...lkm,...lk->...lm", Hll_inv, rhs_l) \
        * lmf[..., None]

    ok = (torch.isfinite(delta).all(dim=-1)
          & torch.isfinite(delta_l).flatten(-2).all(dim=-1))
    delta = torch.where(ok[..., None], delta, torch.zeros_like(delta))
    delta_l = torch.where(ok[..., None, None], delta_l,
                          torch.zeros_like(delta_l))
    return delta, delta_l, ok


def _solve_damped(H, g, free, lam, H_ll, g_l, W, lm_free):
    """Schur-reduced damped solve.

    Dense part: (S·H_red·S + λI) y = S·g_red with Jacobi scaling S.
    Landmarks: per-slot 3×3 inverses of (H_ll + λ·diag(H_ll)), masked by
    ``lm_free``; back-substituted after the reduced solve. Every argument may
    carry the same leading batch dims: all reduced systems go through one
    K1 call (the kernel on a CUDA tensor, its plain version on a CPU one),
    so this is also the reference's ``solve_damped_batched``."""
    Hp, gp, ctx = _damped_reduced_system(H, g, free, lam, H_ll, g_l, W,
                                         lm_free)
    N = Hp.shape[-1]
    y, _ = cholesky_solve_batched(Hp.reshape(-1, N, N), gp.reshape(-1, N))
    return _damped_backsub(y.reshape(gp.shape), ctx)


def solve(window: WindowState, families: Tuple,
          losses: Tuple[Optional[float], ...],
          options: SolverOptions = SolverOptions()
          ) -> Tuple[WindowState, SolveDiagnostics]:
    """Run LM on the window. ``families``/``losses`` are parallel tuples."""
    n_iter = min(options.max_iterations,
                 options.scan_length or options.max_iterations)
    return lm_loop(
        window, lambda w: assemble_normal_equations(w, families, losses),
        n_iter, options)


def marginal_pose_covariance(window: WindowState, families: Tuple,
                             losses: Tuple[Optional[float], ...],
                             slots: torch.Tensor) -> torch.Tensor:
    """Marginal 6-dof pose covariance blocks [S, 6, 6] ([dθ, dp] tangent) of
    the IMU slots ``slots`` [S], from the landmark-Schur-reduced normal
    equations at the current estimate: Jacobi-equilibrated, held/inactive
    dof pinned, Cholesky-factored once, only the requested columns solved
    (bs_common/utils.h:79; vo_localization_validation.h:32-63). A plain
    library Cholesky, as the reference uses outside any kernel."""
    H, _, H_ll, _, W, _ = assemble_normal_equations(window, families, losses)
    dtype, dev = H.dtype, H.device
    Dp = H.shape[-1]
    L = H_ll.shape[-3]
    free = torch.cat([window.dense_free_mask(),
                      torch.zeros(1, dtype=torch.bool, device=dev)]).to(dtype)
    lm_free = (window.landmarks.active & ~window.landmarks.held).to(dtype)

    Hm = H * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
    W = W * free[:, None] * torch.repeat_interleave(
        lm_free, LANDMARK_DOF)[None, :]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    tr = torch.diagonal(H_ll, dim1=-2, dim2=-1).sum(-1)
    Hll_d = H_ll + (1e-5 * tr + 1e-8)[:, None, None] * eye3
    Hll_d = torch.where(lm_free[:, None, None] > 0, Hll_d, eye3)
    Wr = W.reshape(Dp, L, 3)
    Y = torch.einsum("dlk,lkm->dlm", Wr, inv3x3(Hll_d))
    H_red = Hm - torch.einsum("dlm,elm->de", Y, Wr)

    s = torch.rsqrt(torch.clamp(torch.diagonal(H_red), min=_DIAG_EPS))
    Hs = H_red * (s[:, None] * s[None, :]) \
        + 1e-9 * torch.eye(Dp, dtype=dtype, device=dev)
    Lc = torch.linalg.cholesky(Hs)

    cols = (slots[:, None] * win.IMU_DOF
            + torch.arange(6, device=dev)[None, :]).reshape(-1)   # [S*6]
    E = F.one_hot(cols, Dp).to(dtype).T * s[:, None]               # [Dp, S*6]
    X = torch.cholesky_solve(E, Lc) * s[:, None]
    S_req = slots.shape[0]
    Xr = X[cols, :].reshape(S_req, 6, S_req, 6)
    idx = torch.arange(S_req, device=dev)
    cov = Xr[idx, :, idx, :]                                       # [S, 6, 6]
    return 0.5 * (cov + cov.transpose(1, 2))


def lm_loop(window: WindowState, assemble, n_iter: int,
            options: SolverOptions):
    """The LM iteration machinery over a pluggable ``assemble`` function,
    ``assemble(window) -> (H, g, H_ll, g_l, W, cost)``.

    One assembly per iteration: iteration k solves the carried normal
    equations, retracts a trial, and assembles AT THE TRIAL — that single
    pass yields both the trial cost (accept/reject) and, on accept, the next
    iteration's normal equations. Runs exactly ``n_iter`` steps; after the
    ``done`` latch (or with no improvement) a step changes nothing."""
    free_full = window.dense_free_mask()
    free = torch.cat([free_full, torch.zeros_like(free_full[..., :1])], dim=-1)
    lm_free = window.landmarks.active & ~window.landmarks.held

    H, g, H_ll, g_l, W, cost = assemble(window)
    init_cost = cost
    lam = torch.full_like(cost, options.initial_lambda)
    done = torch.zeros_like(cost, dtype=torch.bool)
    iters = torch.zeros_like(cost, dtype=torch.int32)

    def sel(accept, new, old):
        return torch.where(accept.reshape(
            accept.shape + (1,) * (new.dim() - accept.dim())), new, old)

    for _ in range(n_iter):
        active = ~done
        delta, delta_l, ok = _solve_damped(H, g, free, lam, H_ll, g_l, W,
                                           lm_free)
        trial = window.retract_dense(delta[..., :-1])
        trial = trial.replace(landmarks=trial.landmarks.retract(delta_l))
        H_t, g_t, H_ll_t, g_l_t, W_t, new_cost = assemble(trial)
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
        iters = iters + accept.to(torch.int32)
        if options.early_exit and bool(done.all()):
            break

    diag = SolveDiagnostics(initial_cost=init_cost, final_cost=cost,
                            iterations=iters, converged=done,
                            final_lambda=lam)
    return window, diag

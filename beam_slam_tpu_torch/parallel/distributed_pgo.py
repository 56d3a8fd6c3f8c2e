"""Coupled distributed pose-graph optimization over factor shards (port of
:mod:`beam_slam_tpu.parallel.distributed_pgo`).

One global pose graph — the whole-trajectory batch optimization of the
reference (bs_models/src/lib/global_mapping/
global_map_batch_optimization.cpp:1-519) and the submap PGO — with its
factors split over the shards of a :class:`~beam_slam_tpu_torch.parallel.
sharded.Mesh`:

  * the factors and priors are padded to the shard count and split along
    the factor axis (``[F] → [shards..., F / shards]``); the state is one
    copy, read by every shard;
  * every shard linearizes only its own factors (``vmap(jacfwd)`` of the
    residual, the reference's Jacobians) and scatter-adds its 6×6 blocks
    ``JᵢᵀJⱼ`` into a LOCAL ``(H [D, D], g [D], cost)``; all shards
    assemble at once, batched over the leading shard axes;
  * the reference's ``psum`` is a sum over the shard axes, innermost first
    (within a host, then across hosts for the hybrid layout of
    :mod:`.multihost`);
  * one damped, Jacobi-equilibrated solve through K1
    (:func:`ops.cholesky.cholesky_solve_batched` at B = 1) and a
    retraction, with the reference's accept/reject and λ schedule, for
    exactly ``n_iter`` steps. A failed factorization (K1's ``info ≠ 0``
    gives NaN) makes the step non-finite, so it is zero and rejected.

Every shard lives on the mesh's one device. At N poses (D = 6N) the
per-shard equations take ``shards × D² × 4`` bytes: 1.15 GB at N = 1000
over 8 shards.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.autodiff import FORWARD_AD
from beam_slam_tpu_torch.core.window import Struct
from beam_slam_tpu_torch.obs import trace
from beam_slam_tpu_torch.ops.cholesky import cholesky_solve_batched
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.parallel.sharded import Mesh

AXIS = "shards"
POSE_DOF = 6


@dataclasses.dataclass
class PGOState(Struct):
    """Global pose state, one copy read by every shard."""

    q: torch.Tensor      # [N, 4]
    p: torch.Tensor      # [N, 3]
    free: torch.Tensor   # [N] bool — active & !held


@dataclasses.dataclass
class PGOFactors(Struct):
    """Relative-pose factors, split along the factor axis. ``i``/``j``
    index GLOBAL pose slots (cross-shard edges need nothing special: the
    state is shared, only the reduction spans shards)."""

    i: torch.Tensor          # [F] int64
    j: torch.Tensor          # [F] int64
    dq: torch.Tensor         # [F, 4] measured q_i⁻¹ q_j
    dp: torch.Tensor         # [F, 3] measured R_i⁻¹ (p_j - p_i)
    sqrt_info: torch.Tensor  # [F, 6, 6]
    active: torch.Tensor     # [F] bool

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "PGOFactors":
        device = resolve(device)
        return PGOFactors(
            i=torch.zeros(F, dtype=torch.int64, device=device),
            j=torch.zeros(F, dtype=torch.int64, device=device),
            dq=lie.quat_identity((F,), dtype, device),
            dp=torch.zeros(F, 3, dtype=dtype, device=device),
            sqrt_info=torch.zeros(F, 6, 6, dtype=dtype, device=device),
            active=torch.zeros(F, dtype=torch.bool, device=device))


@dataclasses.dataclass
class PGOPriors(Struct):
    """Absolute pose priors (gauge anchors), split like factors."""

    slot: torch.Tensor       # [Fp] int64
    q0: torch.Tensor         # [Fp, 4]
    p0: torch.Tensor         # [Fp, 3]
    sqrt_info: torch.Tensor  # [Fp, 6, 6]
    active: torch.Tensor     # [Fp] bool

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "PGOPriors":
        device = resolve(device)
        return PGOPriors(
            slot=torch.zeros(F, dtype=torch.int64, device=device),
            q0=lie.quat_identity((F,), dtype, device),
            p0=torch.zeros(F, 3, dtype=dtype, device=device),
            sqrt_info=torch.zeros(F, 6, 6, dtype=dtype, device=device),
            active=torch.zeros(F, dtype=torch.bool, device=device))


def _whiten(A, r):
    return torch.einsum("...ij,...j->...i", A, r)


def _rel_residual(q_i, p_i, q_j, p_j, dq, dp, A):
    """[log(dq⁻¹ · (q_i⁻¹ q_j)), R_i⁻¹(p_j − p_i) − dp], whitened — the
    relative-pose residual of the reference PGO factors."""
    q_ij = lie.quat_mul(lie.quat_conj(q_i), q_j)
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(dq), q_ij))
    r_p = lie.quat_rotate(lie.quat_conj(q_i), p_j - p_i) - dp
    return _whiten(A, torch.cat([r_q, r_p], dim=-1))


def _prior_residual(q, p, q0, p0, A):
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
    return _whiten(A, torch.cat([r_q, p - p0], dim=-1))


def _rel_one(delta, qi, pi, qj, pj, dq, dp, A):
    qi2 = lie.quat_mul(qi, lie.so3_exp_quat(delta[0:3]))
    qj2 = lie.quat_mul(qj, lie.so3_exp_quat(delta[6:9]))
    r = _rel_residual(qi2, pi + delta[3:6], qj2, pj + delta[9:12], dq, dp, A)
    return r, r


def _prior_one(delta, q, p, q0, p0, A):
    q2 = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
    r = _prior_residual(q2, p + delta[3:6], q0, p0, A)
    return r, r


def _linearize(fn, n_dof, args):
    """(r [..., 6], J [..., 6, n_dof]) by forward-mode autodiff at δ = 0,
    vmapped over the flattened leading (shard and factor) axes."""
    with trace.span("pgo.linearize"):
        lead = args[0].shape[:-1]
        flat = tuple(a.reshape((-1,) + a.shape[len(lead):]) for a in args)
        zeros = flat[0].new_zeros((flat[0].shape[0], n_dof))
        with FORWARD_AD:   # one forward-AD user at a time (core/autodiff)
            J, r = torch.func.vmap(torch.func.jacfwd(fn, has_aux=True))(
                zeros, *flat)
        return r.reshape(lead + r.shape[1:]), J.reshape(lead + J.shape[1:])


def _block_cols(slots, dof=POSE_DOF):
    """Dense dof of pose slots: [..., n] → [..., n·dof]."""
    cols = slots[..., None] * dof + torch.arange(dof, device=slots.device)
    return cols.reshape(slots.shape[:-1] + (-1,))


def _scatter(H, g, cols, J, r, n_lead):
    """H[..., c, c'] += JᵀJ and g[..., c] -= Jᵀr for every factor, each
    shard (``n_lead`` leading axes) into its own equations."""
    D = H.shape[-1]
    nb = H[..., 0, 0].numel()
    offset = (torch.arange(nb, device=H.device) * D).reshape(
        H.shape[:n_lead] + (1,) * (cols.dim() - n_lead))
    gcols = cols + offset                                 # [..., F, k]
    g.view(-1).index_add_(0, gcols.reshape(-1),
                          -torch.einsum("...ri,...r->...i", J, r).reshape(-1))
    hidx = (gcols[..., :, None] * D + cols[..., None, :])  # [..., F, k, k]
    H.view(-1).index_add_(0, hidx.reshape(-1),
                          torch.einsum("...ri,...rj->...ij", J, J)
                          .reshape(-1))


def _local_normal_eqs(state: PGOState, factors: PGOFactors,
                      priors: PGOPriors):
    """Each shard's contribution to the global normal equations. The
    factors' and priors' leaves carry the same leading shard axes before
    the factor axis (none for a single assembly); returns (H [..., D, D],
    g [..., D], cost [...]) with those axes. The reference builds dense
    one-hot Jacobian rows and one JᵀJ matmul; this scatter-adds the same
    6×6 blocks."""
    N = state.q.shape[0]
    D = N * POSE_DOF
    dtype, dev = state.q.dtype, state.q.device
    lead = factors.i.shape[:-1]
    n_lead = len(lead)
    H = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    g = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    # ---- relative factors
    r, J = _linearize(_rel_one, 2 * POSE_DOF, (
        state.q[factors.i], state.p[factors.i],
        state.q[factors.j], state.p[factors.j],
        factors.dq, factors.dp, factors.sqrt_info))
    m = factors.active.to(dtype)
    r = r * m[..., None]
    J = J * m[..., None, None]
    _scatter(H, g, _block_cols(torch.stack([factors.i, factors.j], -1)),
             J, r, n_lead)
    cost = 0.5 * torch.sum(r * r, dim=(-2, -1))

    # ---- priors
    rp, Jp = _linearize(_prior_one, POSE_DOF, (
        state.q[priors.slot], state.p[priors.slot],
        priors.q0, priors.p0, priors.sqrt_info))
    mp = priors.active.to(dtype)
    rp = rp * mp[..., None]
    Jp = Jp * mp[..., None, None]
    _scatter(H, g, _block_cols(priors.slot[..., None]), Jp, rp, n_lead)
    cost = cost + 0.5 * torch.sum(rp * rp, dim=(-2, -1))
    return H, g, cost


def _retract(state: PGOState, delta: torch.Tensor) -> PGOState:
    N = state.q.shape[0]
    d = delta.reshape(N, POSE_DOF) * state.free.to(delta.dtype)[:, None]
    return state.replace(
        q=lie.quat_normalize(lie.quat_mul(state.q,
                                          lie.so3_exp_quat(d[:, 0:3]))),
        p=state.p + d[:, 3:6])


def _damped_system(H, g, lam, free_dof):
    """The masked, Jacobi-equilibrated, damped system (Hs, gs) and the
    scaling s: held dof get a unit row, every diagonal ~1, then + λI."""
    dtype = H.dtype
    f = free_dof.to(dtype)
    Hm = H * (f[:, None] * f[None, :]) + torch.diag(1.0 - f)
    d = torch.diagonal(Hm)
    s = torch.rsqrt(torch.clamp(d, min=1e-12))
    Hs = Hm * (s[:, None] * s[None, :]) + lam * torch.eye(
        H.shape[-1], dtype=dtype, device=H.device)
    return Hs, g * f * s, s


def _damped_solve(H, g, lam, free_dof):
    """One damped step through K1; a non-finite step (K1's NaN for a
    failed factorization) becomes zero and ``ok`` is False."""
    with trace.span("pgo.damped_system"):
        Hs, gs, s = _damped_system(H, g, lam, free_dof)
    y, _ = cholesky_solve_batched(Hs[None].contiguous(),
                                  gs[None].contiguous())
    delta = y[0] * s * free_dof.to(H.dtype)
    ok = torch.isfinite(delta).all()
    return torch.where(ok, delta, torch.zeros_like(delta)), ok


def _reduce(x: torch.Tensor, n_axes: int) -> torch.Tensor:
    """The reference's psum: sum the ``n_axes`` leading shard axes,
    innermost first (within a host, then across hosts)."""
    for ax in reversed(range(n_axes)):
        x = x.sum(dim=ax)
    return x


def _lm_loop(state: PGOState, factors: PGOFactors, priors: PGOPriors,
             n_iter: int, n_axes: int):
    """The LM loop over the sharded factors (``n_axes`` leading shard axes
    on every factor leaf): one assembly of every shard and one reduction
    per step; exactly ``n_iter`` steps, no host sync inside. Under the
    profiler (:mod:`beam_slam_tpu_torch.obs.trace`) its layers are spans
    of one ``pgo.solve`` and it counts the steps run and accepted."""
    free_dof = torch.repeat_interleave(state.free, POSE_DOF)

    def assemble(st):
        with trace.span("pgo.assemble"):
            H, g, cost = _local_normal_eqs(st, factors, priors)
            return (_reduce(H, n_axes), _reduce(g, n_axes),
                    _reduce(cost, n_axes))

    with trace.span("pgo.solve"):
        H, g, cost = assemble(state)
        c0 = cost
        lam = torch.full_like(cost, 1e-4)
        for _ in range(n_iter):
            with trace.span("pgo.step"):
                delta, ok = _damped_solve(H, g, lam, free_dof)
                with trace.span("pgo.update"):
                    trial = _retract(state, delta)
                H_t, g_t, c_t = assemble(trial)
                with trace.span("pgo.update"):
                    accept = ok & (c_t < cost)
                    state = state.map(lambda a, b: torch.where(accept, b, a),
                                      trial)
                    H = torch.where(accept, H_t, H)
                    g = torch.where(accept, g_t, g)
                    cost = torch.where(accept, c_t, cost)
                    lam = torch.where(accept,
                                      torch.clamp(lam * 0.5, min=1e-12),
                                      torch.clamp(lam * 4.0, max=1e8))
                    trace.count("pgo.lm_steps")
                    trace.count_device("pgo.lm_accepted", accept)
    return state, c0, cost


def _pad(tree, n_shards: int, count: int):
    pad = (-count) % n_shards
    if pad == 0:
        return tree
    return tree.map(lambda x: torch.cat(
        [x, x.new_zeros((pad,) + x.shape[1:])]))


def pad_factors(factors: PGOFactors, n_shards: int) -> PGOFactors:
    """Pad to a multiple of ``n_shards`` with inactive factors."""
    return _pad(factors, n_shards, factors.i.shape[0])


def pad_priors(priors: PGOPriors, n_shards: int) -> PGOPriors:
    return _pad(priors, n_shards, priors.slot.shape[0])


def _split(tree, sizes: Sequence[int]):
    """[F, ...] → [*sizes, F / prod(sizes), ...] on every leaf."""
    return tree.map(lambda x: x.reshape(tuple(sizes) + (-1,) + x.shape[1:]))


def _solve_sharded(mesh: Mesh, axes: Tuple[str, ...], state: PGOState,
                   factors: PGOFactors, priors: PGOPriors, n_iter: int):
    sizes = [mesh.shape[a] for a in axes]
    n_shards = mesh.size
    dev = mesh.device
    factors = _split(pad_factors(factors.to(dev), n_shards), sizes)
    priors = _split(pad_priors(priors.to(dev), n_shards), sizes)
    return _lm_loop(state.to(dev), factors, priors, n_iter, len(sizes))


def solve_distributed(mesh: Mesh, state: PGOState, factors: PGOFactors,
                      priors: PGOPriors, n_iter: int = 20):
    """Coupled LM over the global pose graph with its factors and priors
    padded to the shard count and split over the mesh's shards. Returns
    (state, initial_cost, final_cost)."""
    return _solve_sharded(mesh, tuple(mesh.axis_names), state, factors,
                          priors, n_iter)


def solve_distributed_hybrid(mesh: Mesh, state: PGOState,
                             factors: PGOFactors, priors: PGOPriors,
                             n_iter: int = 20):
    """Coupled LM over a 2-D (hosts × shards) mesh (:mod:`.multihost`
    builds it and the owner-local factor order). The factors are split
    over BOTH axes; each step's reduction sums within a host first, then
    across hosts."""
    return _solve_sharded(mesh, tuple(mesh.axis_names), state, factors,
                          priors, n_iter)


def solve_single(state: PGOState, factors: PGOFactors, priors: PGOPriors,
                 n_iter: int = 20):
    """Serial reference: the identical LM loop over one shard, on the
    state's device."""
    mesh = Mesh((AXIS,), (1,), state.q.device)
    return solve_distributed(mesh, state, factors, priors, n_iter)

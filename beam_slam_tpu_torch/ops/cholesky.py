"""Batched Cholesky factor + solve — kernel K1 of the port.

``cholesky_solve_batched(H, g)`` solves H x = g for B damped, equilibrated
SPD systems. On a CUDA tensor it launches a hand-written Hopper kernel
(replacing the TPU kernel
``beam_slam_tpu/ops/pallas_cholesky.py::cholesky_solve_batched``) in one of
two schedules, picked by :func:`choose_schedule`:

* ``"cluster"`` (``csrc/cholesky.cu``): one thread-block cluster of C CTAs
  factors and solves one system, C chosen by :func:`choose_cluster_size`;
  for many systems, or small ones;
* ``"grid"`` (``csrc/cholesky_grid.cu``): one cooperative launch of a CTA
  per SM works on one system at a time, in panels of GRID_PANEL columns,
  the trailing update spread over the whole card; for few large systems.

On a CPU tensor it takes the plain PyTorch version beside it. A failing
build or launch raises: there is no fallback from the card to the plain
version, nor from one schedule to the other.

:func:`cholesky_solve_blocked_mirror` and :func:`cholesky_solve_grid_mirror`
are the two schedules written out in plain PyTorch, step by step; only
tests use them.

Unlike the TPU kernel, a non-positive pivot is not clamped: ``info`` gets
the 1-based index of the first bad pivot and that system's x is NaN, as the
XLA cholesky path gives the reference's single-window solve.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from beam_slam_tpu_torch.obs import trace
from beam_slam_tpu_torch.ops import nvcc_build

SOURCES = ("cholesky.cu", "cholesky_grid.cu")
# The cluster schedule (csrc/cholesky.cu: TB, UT) and the cluster sizes it
# may be launched with; 16 is Hopper's non-portable maximum.
PANEL, UPDATE_TILE = 32, 64
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# The grid schedule (csrc/cholesky_grid.cu: NB, RB, UT2): its panel width,
# the rows of a panel-solve block and the trailing-update tile. NB = 64 was
# faster than 128 at every N measured on the card, 640 to 6000: a 128-wide
# block, factored by one CTA, costs more on the chain than the steps it
# saves (PERF.md, the panel sweep).
GRID_PANEL = 64
GRID_ROW_BLOCK, GRID_UPDATE_TILE = 32, 128
SCHEDULES = ("cluster", "grid")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set its C signature."""
    path, _, _ = nvcc_build.build("bst_cholesky", SOURCES)
    lib = ctypes.CDLL(str(path))
    fn = lib.bst_cholesky_solve_batched_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bst_cholesky_max_active_clusters.argtypes = [ctypes.c_int]
    lib.bst_cholesky_max_active_clusters.restype = ctypes.c_int
    fn = lib.bst_cholesky_grid_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bst_cholesky_grid_work_floats.argtypes = [ctypes.c_int] * 2
    lib.bst_cholesky_grid_work_floats.restype = ctypes.c_longlong
    lib.bst_cholesky_grid_ctas.argtypes = []
    lib.bst_cholesky_grid_ctas.restype = ctypes.c_int
    return lib


def choose_cluster_size(B: int, slots: Dict[int, int]) -> int:
    """CTAs per system: the largest cluster size of which the card holds B
    at once on SMs of their own (``slots``: size → that many), so that no
    system waits for another or shares its SMs; 1 where no size does."""
    for C in CLUSTER_SIZES:
        if slots.get(C, 0) >= B:
            return C
    return 1


# Where the grid schedule beats the cluster schedule, measured on the card
# (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py k1, "K1 ms by N" and "K1
# schedules by (B, N)"): by the SMs that the cluster schedule keeps busy,
# B systems of C CTAs, the least N at which the grid was faster. B = 1 on
# 16 SMs: 768 cluster, 896 grid; B = 2 on 32: 1536 cluster, 2048 grid;
# B = 4 and B = 8 on 64: 2048 cluster, 3072 grid. Larger batches were not
# measured and keep the cluster schedule.
GRID_MIN_N = {16: 896, 32: 2048, 64: 3072}
GRID_MAX_B = 8


def choose_schedule(B: int, N: int, n_sms: int, slots: Dict[int, int]
                    ) -> str:
    """The schedule of K1 for B systems of N unknowns on a card that runs a
    cooperative grid of ``n_sms`` CTAs (0: none) and holds ``slots[C]``
    clusters of C CTAs at once: ``"grid"`` where GRID_MIN_N says it was
    faster for the B·C SMs the cluster schedule would keep busy,
    ``"cluster"`` everywhere else."""
    if n_sms < 1 or B > GRID_MAX_B:
        return "cluster"
    busy = B * choose_cluster_size(B, slots)
    for sms in sorted(GRID_MIN_N):
        if busy <= sms:
            return "grid" if N >= GRID_MIN_N[sms] else "cluster"
    return "cluster"


@functools.cache
def grid_ctas(device_index: int) -> int:
    """CTAs of the grid schedule on the card: one an SM, or 0 where the card
    has no cooperative launch or cannot hold the kernel's CTA on an SM. A
    CUDA error of the query raises. Called before the first grid launch on
    a card: it also raises the kernel's shared memory limit there."""
    fn = load_library().bst_cholesky_grid_ctas
    with torch.cuda.device(device_index):
        ctas = fn()
    if ctas < 0:
        raise RuntimeError(f"cholesky grid schedule: the CTA query failed "
                           f"with cudaError {-ctas}")
    return ctas


@functools.cache
def cluster_slots(device_index: int) -> Dict[int, int]:
    """Cluster size → how many clusters of that size the card can run at
    once with one CTA on an SM (0 where it cannot schedule the size): the
    occupancy the runtime reports, over the CTAs it would stack on an SM."""
    fn = load_library().bst_cholesky_max_active_clusters
    with torch.cuda.device(device_index):
        active = {C: max(fn(C), 0) for C in CLUSTER_SIZES}
    n_sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    per_sm = max(active[1] // n_sms, 1)
    return {C: n // per_sm for C, n in active.items()}


def _check(H: torch.Tensor, g: torch.Tensor) -> None:
    if H.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"float32 required, got {H.dtype} / {g.dtype}")
    if H.dim() != 3 or g.dim() != 2 or H.shape[1] != H.shape[2] \
            or H.shape[:2] != g.shape:
        raise ValueError(f"need H [B,N,N] and g [B,N]; got {tuple(H.shape)} "
                         f"and {tuple(g.shape)}")
    if H.shape[0] < 1 or H.shape[1] < 1:
        raise ValueError(f"empty system {tuple(H.shape)}")
    if H.device != g.device:
        raise ValueError(f"H on {H.device}, g on {g.device}")
    if not (H.is_contiguous() and g.is_contiguous()):
        raise ValueError("H and g must be contiguous")


def cholesky_solve_batched_reference(H: torch.Tensor, g: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (x [B,N], info [B] int32). ``cholesky_ex`` returns a
    partial factor on failure, so failed systems are mapped to NaN here —
    otherwise the solver's finite-step gate would pass a bad step."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[..., None], L)[..., 0]
    x = torch.where((info > 0)[:, None], torch.full_like(x, float("nan")), x)
    return x, info.to(torch.int32)


def _factor_invert_tile(T: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The kernel's diagonal-tile step on a PANEL×PANEL lower tile (padded
    with the identity): right-looking Cholesky with the inverse carried
    along. Returns (L⁻¹, 0), or (None, j) at the first bad pivot j (1-based
    within the tile)."""
    T = T.clone()
    W = torch.eye(PANEL, dtype=T.dtype)
    for j in range(PANEL):
        d = float(T[j, j])
        if not (d > 0.0 and math.isfinite(d)):
            return None, j + 1
        inv = torch.rsqrt(T[j, j])
        inv = inv * (1.5 - (0.5 * T[j, j] * inv) * inv)  # one Newton step
        T[j + 1:, j] *= inv
        T[j, j] = T[j, j] * inv
        W[j] = W[j] * inv
        v = T[j + 1:, j]
        T[j + 1:, j + 1:] -= torch.outer(v, v)
        W[j + 1:] -= torch.outer(v, W[j])
    return W, 0


def _mirror_one(H: torch.Tensor, g: torch.Tensor
                ) -> Tuple[torch.Tensor, int]:
    N = g.shape[0]
    nan = torch.full_like(g, float("nan"))
    low = torch.tril(torch.ones(N, N, dtype=torch.bool))
    # the scratch copy: the upper triangle is never read, so poison it
    A = torch.where(low, H, torch.full_like(H, float("nan")))
    x = g.clone()

    def factor_and_publish(k0: int, tile: torch.Tensor) -> int:
        """Rank 0: factor the diagonal tile at k0 (given with every earlier
        panel's update applied), leave L_kk⁻¹ in its place and y_k over
        g_k. Returns the 1-based index of a bad pivot, or 0."""
        kb = tile.shape[0]
        T = torch.eye(PANEL, dtype=H.dtype)
        T[:kb, :kb] = torch.tril(tile)
        X, bad = _factor_invert_tile(T)
        if bad:
            return k0 + bad
        X = X[:kb, :kb]
        A[k0:k0 + kb, k0:k0 + kb] = torch.where(low[:kb, :kb], X,
                                                A[k0:k0 + kb, k0:k0 + kb])
        x[k0:k0 + kb] = X @ x[k0:k0 + kb]
        return 0

    kb = min(PANEL, N)
    bad = factor_and_publish(0, A[:kb, :kb])
    for k0 in range(0, N, PANEL):
        if bad:
            return nan, bad
        r0 = k0 + min(PANEL, N - k0)
        if r0 >= N:
            break
        X, y = torch.tril(A[k0:r0, k0:r0]), x[k0:r0].clone()
        # 2. panel solve as a product with L_kk⁻ᵀ; g rides along as a row
        for rb in range(r0, N, PANEL):
            re = min(rb + PANEL, N)
            Lp = A[rb:re, k0:r0] @ X.T
            A[rb:re, k0:r0] = Lp
            x[rb:re] -= Lp @ y
        # 3. look-ahead: the next diagonal tile less L0·L0ᵀ has all of its
        #    update, so rank 0 factors it now
        rn = min(r0 + PANEL, N)
        L0 = A[r0:rn, k0:r0]
        bad = factor_and_publish(r0, A[r0:rn, r0:rn] - L0 @ L0.T)
        # 4. trailing update of the lower triangle, UPDATE_TILE² tiles, the
        #    rows of the tile just factored left out
        for ri in range(r0, N, UPDATE_TILE):
            ie = min(ri + UPDATE_TILE, N)
            lo = max(ri, rn)
            for rl in range(r0, ri + 1, UPDATE_TILE):
                le = min(rl + UPDATE_TILE, N)
                upd = A[lo:ie, rl:le] - A[lo:ie, k0:r0] @ A[rl:le, k0:r0].T
                A[lo:ie, rl:le] = torch.where(low[lo:ie, rl:le], upd,
                                              A[lo:ie, rl:le])
    if bad:
        return nan, bad
    # backward substitution Lᵀ x = y with the inverted diagonal tiles
    for k0 in range(((N - 1) // PANEL) * PANEL, -1, -PANEL):
        r0 = min(k0 + PANEL, N)
        s = x[k0:r0] - A[r0:, k0:r0].T @ x[r0:]
        x[k0:r0] = torch.tril(A[k0:r0, k0:r0]).T @ s
    return x, 0


def cholesky_solve_blocked_mirror(H: torch.Tensor, g: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cluster schedule (``csrc/cholesky.cu``) in plain PyTorch on the
    CPU, for tests: PANEL-wide panels; the diagonal tile factored and
    inverted one panel ahead of the trailing update; the panel solve as a
    product with the inverse; g carried as one more row; the trailing
    update on lower-triangle tiles only; the backward substitution with the
    inverted tiles; ``info`` and NaN on a bad pivot."""
    _check(H, g)
    xs, infos = zip(*(_mirror_one(Hb, gb) for Hb, gb in zip(H, g)))
    return torch.stack(xs), torch.tensor(infos, dtype=torch.int32)


def _grid_factor(A: torch.Tensor, w: torch.Tensor, d0: int, NB: int) -> int:
    """The grid schedule's diagonal-block step on the NB×NB block at d0 (all
    of its update applied): each 32-wide sub-panel in turn, its 32×32 tile
    factored and inverted, the tiles below it solved by product with that
    inverse, the rest of the block updated; then L⁻¹ assembled by distance
    from the diagonal, (L⁻¹)_ts = −L_tt⁻¹ Σ_u L_tu (L⁻¹)_us. Leaves L⁻¹ over
    the block's lower triangle in A and y = L⁻¹ g over g in w. Returns the
    1-based index of a bad pivot, or 0."""
    N = w.shape[0]
    kb = min(NB, N - d0)
    D = torch.eye(NB, dtype=A.dtype)
    D[:kb, :kb] = torch.tril(A[d0:d0 + kb, d0:d0 + kb])
    Y = torch.zeros_like(D)
    ns = NB // PANEL

    def blk(M, t, s):
        return M[t * PANEL:(t + 1) * PANEL, s * PANEL:(s + 1) * PANEL]

    for s in range(ns):
        X, bad = _factor_invert_tile(torch.tril(blk(D, s, s)))
        if bad:
            return d0 + s * PANEL + bad
        blk(Y, s, s)[:] = X
        for t in range(s + 1, ns):
            blk(D, t, s)[:] = blk(D, t, s) @ X.T
        for t in range(s + 1, ns):
            for u in range(s + 1, t + 1):
                blk(D, t, u)[:] -= blk(D, t, s) @ blk(D, u, s).T
    for d in range(1, ns):
        for s in range(ns - d):
            t = s + d
            Z = sum(blk(D, t, u) @ blk(Y, u, s) for u in range(s, t))
            blk(Y, t, s)[:] = -blk(Y, t, t) @ Z
    g = torch.zeros(NB, dtype=A.dtype)
    g[:kb] = w[d0:d0 + kb]
    low = torch.tril(torch.ones(kb, kb, dtype=torch.bool))
    A[d0:d0 + kb, d0:d0 + kb] = torch.where(low, Y[:kb, :kb],
                                            A[d0:d0 + kb, d0:d0 + kb])
    w[d0:d0 + kb] = (Y @ g)[:kb]
    return 0


def _grid_mirror_one(H: torch.Tensor, g: torch.Tensor, NB: int
                     ) -> Tuple[torch.Tensor, int]:
    N = g.shape[0]
    low = torch.tril(torch.ones(N, N, dtype=torch.bool))
    # the scratch copy: the upper triangle is never read, so poison it
    A = torch.where(low, H, torch.full_like(H, float("nan")))
    w = g.clone()
    nan = torch.full_like(g, float("nan"))
    UT, RB = GRID_UPDATE_TILE, GRID_ROW_BLOCK

    def update(I0, ie, J0, je, k0, r0, keep):
        upd = A[I0:ie, J0:je] - A[I0:ie, k0:r0] @ A[J0:je, k0:r0].T
        A[I0:ie, J0:je] = torch.where(keep[I0:ie, J0:je], upd,
                                      A[I0:ie, J0:je])

    # init: CTA 0 factors the first block while the others copy
    bad = _grid_factor(A, w, 0, NB)
    for k0 in range(0, N - NB, NB):
        if bad:
            return nan, bad
        r0 = k0 + NB
        # panel: row blocks of RB; L_ik = A_ik·L_kk⁻ᵀ, g carried as a row
        Y, y = torch.tril(A[k0:r0, k0:r0]), w[k0:r0].clone()
        for R in range(r0, N, RB):
            e = min(R + RB, N)
            Lp = A[R:e, k0:r0] @ Y.T
            A[R:e, k0:r0] = Lp
            w[R:e] -= Lp @ y
        # update: CTA 0 takes the next diagonal block's share and factors
        # the block (look-ahead); the others take lower-triangle tiles of
        # UT, the diagonal block left out
        rn = min(r0 + NB, N)
        update(r0, rn, r0, rn, k0, r0, low)
        bad = _grid_factor(A, w, r0, NB)
        rest = low.clone()
        rest[r0:rn, r0:rn] = False
        for I0 in range(r0, N, UT):
            for J0 in range(r0, I0 + 1, UT):
                update(I0, min(I0 + UT, N), J0, min(J0 + UT, N), k0, r0,
                       rest)
    if bad:
        return nan, bad
    # backward: x_m = L_mm⁻ᵀ y_m, then y_j −= L_mjᵀ x_m for every j < m
    x = torch.empty_like(g)
    for m0 in range(((N - 1) // NB) * NB, -1, -NB):
        e = min(m0 + NB, N)
        x[m0:e] = torch.tril(A[m0:e, m0:e]).T @ w[m0:e]
        w[:m0] -= A[m0:e, :m0].T @ x[m0:e]
    return x, 0


def cholesky_solve_grid_mirror(H: torch.Tensor, g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid schedule (``csrc/cholesky_grid.cu``) in plain PyTorch on the
    CPU, for tests: panels of GRID_PANEL columns; the diagonal block factored
    by 32-wide sub-panels and inverted; the panel solve as a product with
    that inverse, in row blocks, g carried as one more row; the next
    diagonal block updated and factored first (look-ahead); the rest of
    the trailing update on lower-triangle tiles only; the backward pass
    with the inverted blocks; ``info`` and NaN on a bad pivot. Systems of a
    batch are solved in turn."""
    _check(H, g)
    xs, infos = zip(*(_grid_mirror_one(Hb, gb, GRID_PANEL)
                      for Hb, gb in zip(H, g)))
    return torch.stack(xs), torch.tensor(infos, dtype=torch.int32)


def _solve_grid(H: torch.Tensor, g: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the grid schedule on the card (inputs checked)."""
    lib = load_library()
    B, N = g.shape
    ctas = grid_ctas(H.device.index)
    if ctas < 1:
        raise RuntimeError("this card cannot run K1's grid schedule "
                           "(no cooperative grid of one CTA an SM)")
    scratch = torch.empty_like(H)
    x = torch.empty_like(g)
    info = torch.empty(B, dtype=torch.int32, device=H.device)
    work = torch.empty(lib.bst_cholesky_grid_work_floats(B, N),
                       dtype=torch.float32, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bst_cholesky_grid_solve_f32(
            H.data_ptr(), g.data_ptr(), scratch.data_ptr(), x.data_ptr(),
            info.data_ptr(), work.data_ptr(), B, N, ctas, stream)
    if err != 0:
        raise RuntimeError(f"cholesky grid kernel launch failed: cudaError "
                           f"{err}")
    return x, info


def cholesky_solve_batched(H: torch.Tensor, g: torch.Tensor,
                           cluster: Optional[int] = None,
                           schedule: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = g. H: [B, N, N] f32 SPD (only the lower triangle is
    read), g: [B, N] f32, contiguous, any N ≥ 1. Returns (x [B, N] f32,
    info [B] int32: 0, or the 1-based index of the first non-positive
    pivot, in which case x[b] is NaN). Measurement knobs, checked on every
    device: ``schedule`` ("cluster" or "grid"; the default is
    :func:`choose_schedule` on the card's limits) and ``cluster`` (CTAs per
    system of the cluster schedule, which it implies; default
    :func:`choose_cluster_size`)."""
    _check(H, g)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    if cluster is not None and schedule == "grid":
        raise ValueError("cluster= is the cluster schedule's knob")
    B, N = g.shape
    if H.device.type == "cpu":
        with trace.span("k1.solve", B=B, N=N, schedule="plain"):
            return cholesky_solve_batched_reference(H, g)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    dev = H.device.index
    if schedule is None:
        schedule = "cluster" if cluster is not None else _schedule(B, N, dev)
    with trace.span("k1.solve", B=B, N=N, schedule=schedule):
        if schedule == "grid":
            x, info = _solve_grid(H, g)
        else:
            x, info = _solve_cluster(H, g, cluster)
    with _LAUNCHES_LOCK:  # the smoother's async worker launches K1 too
        cholesky_solve_batched.launches += 1
        cholesky_solve_batched.shapes[(B, N)] += 1
    return x, info


@functools.lru_cache(maxsize=256)
def _schedule(B: int, N: int, device_index: int) -> str:
    return choose_schedule(B, N, grid_ctas(device_index),
                           cluster_slots(device_index))


def _solve_cluster(H: torch.Tensor, g: torch.Tensor, cluster: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the cluster schedule on the card (inputs checked)."""
    fn = load_library().bst_cholesky_solve_batched_f32
    B, N = g.shape
    if cluster is None:
        cluster = choose_cluster_size(B, cluster_slots(H.device.index))
    scratch = torch.empty_like(H)
    x = torch.empty_like(g)
    info = torch.empty(B, dtype=torch.int32, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(H.data_ptr(), g.data_ptr(), scratch.data_ptr(), x.data_ptr(),
                 info.data_ptr(), B, N, cluster, stream)
    if err != 0:
        raise RuntimeError(f"cholesky kernel launch failed: cudaError {err}")
    return x, info


cholesky_solve_batched.launches = 0
# launches by (B, N); the ATE runner reports the shapes its sessions gave K1
cholesky_solve_batched.shapes = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()

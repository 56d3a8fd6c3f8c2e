"""Batched Cholesky factor + solve — kernel K1 of the port.

``cholesky_solve_batched(H, g)`` solves H x = g for B damped, equilibrated
SPD systems. On a CUDA tensor it launches the hand-written Hopper kernel of
``csrc/cholesky.cu`` (replacing the TPU kernel
``beam_slam_tpu/ops/pallas_cholesky.py::cholesky_solve_batched``): one
thread-block cluster of C CTAs factors and solves one system, C chosen by
:func:`choose_cluster_size`. On a CPU tensor it takes the plain PyTorch
version beside it. A failing build or launch raises: there is no fallback
from the card to the plain version.

:func:`cholesky_solve_blocked_mirror` is the kernel's schedule written out
in plain PyTorch, step by step; only tests use it.

Unlike the TPU kernel, a non-positive pivot is not clamped: ``info`` gets
the 1-based index of the first bad pivot and that system's x is NaN, as the
XLA cholesky path gives the reference's single-window solve.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from beam_slam_tpu_torch.ops import nvcc_build

SOURCES = ("cholesky.cu",)
# The kernel's schedule (csrc/cholesky.cu: TB, UT) and the cluster sizes it
# may be launched with; 16 is Hopper's non-portable maximum.
PANEL, UPDATE_TILE = 32, 64
CLUSTER_SIZES = (16, 8, 4, 2, 1)


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
    return lib


def choose_cluster_size(B: int, slots: Dict[int, int]) -> int:
    """CTAs per system: the largest cluster size of which the card holds B
    at once on SMs of their own (``slots``: size → that many), so that no
    system waits for another or shares its SMs; 1 where no size does."""
    for C in CLUSTER_SIZES:
        if slots.get(C, 0) >= B:
            return C
    return 1


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
    """The CUDA kernel's schedule in plain PyTorch on the CPU, for tests:
    PANEL-wide panels; the diagonal tile factored and inverted one panel
    ahead of the trailing update; the panel solve as a product with the
    inverse; g carried as one more row; the trailing update on
    lower-triangle tiles only; the backward substitution with the inverted
    tiles; ``info`` and NaN on a bad pivot."""
    _check(H, g)
    xs, infos = zip(*(_mirror_one(Hb, gb) for Hb, gb in zip(H, g)))
    return torch.stack(xs), torch.tensor(infos, dtype=torch.int32)


def cholesky_solve_batched(H: torch.Tensor, g: torch.Tensor,
                           cluster: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = g. H: [B, N, N] f32 SPD (only the lower triangle is
    read), g: [B, N] f32, contiguous, any N ≥ 1. Returns (x [B, N] f32,
    info [B] int32: 0, or the 1-based index of the first non-positive
    pivot, in which case x[b] is NaN). ``cluster`` overrides the number of
    CTAs per system (a measurement knob; the default is
    :func:`choose_cluster_size` on the card's limits)."""
    _check(H, g)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    if H.device.type == "cpu":
        return cholesky_solve_batched_reference(H, g)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
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
    with _LAUNCHES_LOCK:  # the smoother's async worker launches K1 too
        cholesky_solve_batched.launches += 1
    return x, info


cholesky_solve_batched.launches = 0
_LAUNCHES_LOCK = threading.Lock()

"""Exact k-nearest-neighbour top-k — kernel K2 of the port.

``knn_topk(query, ref, ref_valid, k)`` gives, for every query point, the k
nearest valid reference points: (idx [Q,k] int64, d2 [Q,k] f32), ascending
by distance, with invalid refs at +inf. On a CUDA tensor it launches the
hand-written Hopper kernel of ``csrc/knn.cu`` (replacing the TPU kernel
``beam_slam_tpu/ops/pallas_knn.py::knn_topk``): a thread-block cluster of S
CTAs takes a tile of 32 queries and splits R over its CTAs and their warps,
S chosen by :func:`choose_cluster_size`. On a CPU tensor it takes the plain
PyTorch version beside it. A failing build or launch raises: there is no
fallback from the card to the plain version.

:func:`knn_topk_split_mirror` is the kernel's schedule written out in plain
PyTorch (the parts of R, the shared pruning threshold, the merge by
(d², index)); only tests and the insertion counts of ``chip_smoke.py`` use
it.

Both compute the reference path's function (exact ``top_k`` over
‖q‖² + ‖r‖² − 2q·r with invalid refs at +inf), not the TPU kernel's
packed-key approximation. Ties keep the lower index in the kernel, as the
reference's ``top_k`` does; ``torch.topk`` in the plain version leaves the
order of equal distances open, so the two agree on distances and on
neighbour sets up to swaps between equal distances. Slots left at +inf hold
index 0, which is in range (callers gather ``ref[idx]`` before masking).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from beam_slam_tpu_torch.ops import nvcc_build

SOURCES = ("knn.cu",)
KS = (1, 5, 8, 10)          # the k the kernel is instantiated for
CHUNK = 1024                # plain version: query rows per distance block
CPU_CHUNK = 128             # ... on the CPU, where a block stays in cache
# The kernel's schedule (csrc/knn.cu: QT, W, T): a cluster of S CTAs takes
# QUERY_TILE queries, one a lane; R is cut into steps of STEP refs, dealt
# round-robin to the cluster's S·WARPS warps; S is one of CLUSTER_SIZES.
QUERY_TILE, WARPS, STEP = 32, 8, 64
CLUSTER_SIZES = (1, 2, 4, 8)
# S is the smallest size whose resident warps give every SM this many
MIN_WARPS_PER_SM = 8
_EMPTY = 2 ** 31 - 1        # the index of a list slot not yet filled


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set its C signature."""
    path, _, _ = nvcc_build.build("bst_knn", SOURCES)
    lib = ctypes.CDLL(str(path))
    fn = lib.bst_knn_topk_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bst_knn_max_active_clusters.argtypes = [ctypes.c_int]
    lib.bst_knn_max_active_clusters.restype = ctypes.c_int
    return lib


def choose_cluster_size(Q: int, slots: Dict[int, int], n_sms: int) -> int:
    """CTAs per query tile: the smallest cluster size S at which the query
    tiles the card holds at once (``slots``: size → clusters resident at
    once) give its ``n_sms`` SMs MIN_WARPS_PER_SM warps each; the largest
    schedulable size where none does."""
    tiles = -(-Q // QUERY_TILE)
    usable = [S for S in CLUSTER_SIZES if slots.get(S, 0) >= 1] or [1]
    for S in usable:
        if min(tiles, slots[S]) * S * WARPS >= MIN_WARPS_PER_SM * n_sms:
            return S
    return usable[-1]


@functools.cache
def cluster_slots(device_index: int) -> Dict[int, int]:
    """Cluster size → clusters of the kernel the card holds at once (0
    where it cannot schedule the size), as the runtime reports it."""
    fn = load_library().bst_knn_max_active_clusters
    with torch.cuda.device(device_index):
        return {S: max(fn(S), 0) for S in CLUSTER_SIZES}


def _check(query, ref, ref_valid, k) -> None:
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"float32 points required, got {query.dtype} / "
                        f"{ref.dtype}")
    if ref_valid.dtype != torch.bool:
        raise TypeError(f"ref_valid must be bool, got {ref_valid.dtype}")
    if (query.dim() != 2 or query.shape[1] != 3 or ref.dim() != 2
            or ref.shape[1] != 3 or ref_valid.shape != ref.shape[:1]):
        raise ValueError(f"need query [Q,3], ref [R,3], ref_valid [R]; got "
                         f"{tuple(query.shape)}, {tuple(ref.shape)}, "
                         f"{tuple(ref_valid.shape)}")
    if not 1 <= k <= ref.shape[0]:
        raise ValueError(f"k={k} must lie in [1, R={ref.shape[0]}]")
    if not (query.device == ref.device == ref_valid.device):
        raise ValueError(f"query on {query.device}, ref on {ref.device}, "
                         f"ref_valid on {ref_valid.device}")
    if not (query.is_contiguous() and ref.is_contiguous()
            and ref_valid.is_contiguous()):
        raise ValueError("query, ref and ref_valid must be contiguous")


def _distances(query, ref, ref_valid, ref_sq=None):
    """[Q, R] squared distances by the plain version's expansion
    (|q|² + |r|²) - 2 q·r, +inf at invalid refs (``ref_valid`` None: all
    valid). ``ref_sq``: the refs' |r|² as a [1, R] row, if already at hand.
    One [Q, R] block is written in place: 2 q·r is exact in float32, so
    subtracting it with ``alpha=2`` rounds as the subtraction of the
    product does."""
    if ref_sq is None:
        ref_sq = torch.sum(ref * ref, dim=1)[None, :]
    d = torch.sum(query * query, dim=1, keepdim=True) + ref_sq
    d.sub_(query @ ref.T, alpha=2.0)
    if ref_valid is None:
        return d
    return d.masked_fill_(~ref_valid[None, :], float("inf"))


def knn_topk_reference(query: torch.Tensor, ref: torch.Tensor,
                       ref_valid: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: matmul distances + ``torch.topk(largest=False)``, in blocks
    of ``CHUNK`` query rows (rows are independent, so blocking changes
    nothing but the peak memory). When at least k refs are valid, only the
    valid ones enter the distances, in their order, and the indices are
    mapped back: a ref at +inf is then never among the k nearest, so this
    changes nothing but the work (a map of the LIO path is ~80% invalid
    padding). Finding them waits for the device."""
    keep = torch.nonzero(ref_valid).squeeze(1)
    if keep.numel() >= k:
        ref, ref_valid = ref[keep], None
    else:
        keep = None
    ref_sq = torch.sum(ref * ref, dim=1)[None, :]
    idx, d2 = [], []
    for qc in torch.split(query, CHUNK if query.is_cuda else CPU_CHUNK):
        v, i = torch.topk(_distances(qc, ref, ref_valid, ref_sq), k, dim=1,
                          largest=False)
        idx.append(i if keep is None else keep[i])
        d2.append(v)
    if not idx:
        return (torch.zeros((0, k), dtype=torch.int64, device=query.device),
                torch.zeros((0, k), dtype=query.dtype, device=query.device))
    return torch.cat(idx), torch.cat(d2)


def knn_topk_split_mirror(query: torch.Tensor, ref: torch.Tensor,
                          ref_valid: torch.Tensor, k: int, cluster: int = 1,
                          warps: int = WARPS, prune: Optional[str] = None,
                          lag: int = 0, counts: Optional[dict] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's schedule in plain PyTorch, for tests and counts.

    R is cut into steps of STEP refs; step g is part g mod P's, P =
    ``cluster``·``warps``, one part a warp. For every query a part keeps a
    sorted k-list of (d², index) of its own refs, visited in ascending
    index (invalid refs, at +inf, never enter). A ref enters when d < the
    list's k-th distance (strict: the list's refs have lower indices). The
    part lists are merged by (d², index); slots still empty hold +inf and
    index 0. That is the kernel (``prune=None``).

    ``prune`` adds a threshold shared by a CTA's warps, which the kernel
    measured slower than the insertions it saved and does not have; the
    counts of ``chip_smoke.py knn-counts`` compare the two. With it a ref
    enters only when also d <= the least k-th distance that any of the
    CTA's warps had published when the step began. The warps go in rounds
    of one step each; ``lag`` starts part p's steps lag·(P−1−p) rounds
    late, so that the higher parts run ahead, as warps drift apart on the
    card (0: lockstep). ``<=`` is the rule: a ref at another part's k-th
    distance may still win on a lower index. ``"<"`` is that wrong rule,
    kept to show what it drops.

    ``counts``, if given, receives, per query tile and part,
    ``warp_insertions`` (refs at which some lane of the warp inserts, so
    that the whole warp runs the insertion) and ``scanned`` (valid refs the
    warp scans), and ``lane_insertions`` (insertions summed over lanes)."""
    _check(query, ref, ref_valid, k)
    if prune not in ("<=", "<", None):
        raise ValueError(f"prune must be '<=', '<' or None, not {prune!r}")
    Q, R = query.shape[0], ref.shape[0]
    P = cluster * warps
    dev = query.device
    dist = _distances(query, ref, ref_valid)
    parts = torch.arange(P, device=dev)
    rounds = -(-R // (P * STEP))
    late = lag * (P - 1 - parts)   # rounds each part starts late
    inf = float("inf")
    bd = torch.full((Q, P, k), inf, dtype=query.dtype, device=dev)
    bi = torch.full((Q, P, k), _EMPTY, dtype=torch.int64, device=dev)
    tiles = -(-Q // QUERY_TILE)
    warp_ins = torch.zeros(tiles, P, dtype=torch.int64, device=dev)
    scanned = torch.zeros(P, dtype=torch.int64, device=dev)
    lane_ins = 0
    for tau in range(rounds + lag * (P - 1)):
        step = tau - late
        live = (step >= 0) & (step < rounds)
        start = (step * P + parts) * STEP
        if prune is not None:
            kth = bd[..., -1].reshape(Q, cluster, warps).amin(-1)
            shared = kth.repeat_interleave(warps, dim=1)
        for t in range(STEP):
            pos = start + t
            inside = live & (pos < R)
            pos = torch.clamp(pos, 0, R - 1)
            d = torch.where(inside[None], dist[:, pos],
                            torch.full((Q, P), inf, device=dev))
            ins = d < bd[..., -1]
            if prune == "<=":
                ins &= d <= shared
            elif prune == "<":
                ins &= d < shared
            # slot j takes slot j-1's entry, or the new one at the first slot
            # it beats; slots before that keep theirs
            m = (d[..., None] < bd) & ins[..., None]
            m_prev = F.pad(m[..., :-1], (1, 0))
            prev_d = F.pad(bd[..., :-1], (1, 0), value=inf)
            prev_i = F.pad(bi[..., :-1], (1, 0), value=_EMPTY)
            bd = torch.where(m, torch.where(m_prev, prev_d, d[..., None]), bd)
            bi = torch.where(m, torch.where(m_prev, prev_i,
                                            pos[None, :, None]), bi)
            if counts is not None:
                scanned += inside & ref_valid[pos]
                lane_ins += int(ins.sum())
                warp_ins += F.pad(ins, (0, 0, 0, tiles * QUERY_TILE - Q)
                                  ).reshape(tiles, QUERY_TILE, P).any(1)
    if counts is not None:
        counts.update(warp_insertions=warp_ins, lane_insertions=lane_ins,
                      scanned=scanned.expand(tiles, P))
    # merge by (d², index): order by index, then stably by distance
    d, i = bd.reshape(Q, P * k), bi.reshape(Q, P * k)
    o = torch.argsort(i, dim=1, stable=True)
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.argsort(d, dim=1, stable=True)[:, :k]
    d, i = d.gather(1, o), i.gather(1, o)
    return torch.where(torch.isinf(d), torch.zeros_like(i), i), d


def require_ks(ks, device, what: str) -> None:
    """Raise unless the kernel is built for every k in ``ks`` — on the card
    only (the plain version takes any k). Strategies call it at
    construction, so that a configuration the kernel cannot serve fails
    there and not at its first launch."""
    if torch.device(device).type != "cuda":
        return
    bad = sorted({int(k) for k in ks} - set(KS))
    if bad:
        raise ValueError(f"{what} asks the kNN kernel for k={bad}; it is "
                         f"built for k in {KS}")


def knn_topk(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
             k: int, cluster: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid refs per query: (idx [Q,k] int64, d2 [Q,k] f32).
    query [Q,3] f32, ref [R,3] f32, ref_valid [R] bool, contiguous, 1 ≤ k ≤ R;
    on the card k must be one of ``KS``. ``cluster`` overrides the number of
    CTAs that split R for each query tile (a measurement knob; the default
    is :func:`choose_cluster_size` on the card's limits)."""
    _check(query, ref, ref_valid, k)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    if query.device.type == "cpu":
        return knn_topk_reference(query, ref, ref_valid, k)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    if k not in KS:
        raise ValueError(f"the kNN kernel is built for k in {KS}, not {k}")
    Q, R = query.shape[0], ref.shape[0]
    idx = torch.empty((Q, k), dtype=torch.int64, device=query.device)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=query.device)
    if Q == 0:
        return idx, d2
    fn = load_library().bst_knn_topk_f32
    if cluster is None:
        dev = query.device.index
        cluster = choose_cluster_size(
            Q, cluster_slots(dev),
            torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(),
                 idx.data_ptr(), d2.data_ptr(), Q, R, k, cluster, stream)
    if err != 0:
        raise RuntimeError(f"kNN kernel launch failed: cudaError {err}")
    knn_topk.launches += 1
    return idx, d2


knn_topk.launches = 0

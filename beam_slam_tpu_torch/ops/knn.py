"""Exact k-nearest-neighbour top-k — kernel K2 of the port.

``knn_topk(query, ref, ref_valid, k)`` gives, for every query point, the k
nearest valid reference points: (idx [Q,k] int64, d2 [Q,k] f32), ascending
by distance, with invalid refs at +inf. On a CUDA tensor it launches the
hand-written Hopper kernel of ``csrc/knn.cu`` (replacing the TPU kernel
``beam_slam_tpu/ops/pallas_knn.py::knn_topk``); on a CPU tensor it takes the
plain PyTorch version beside it. A failing build or launch raises: there is
no fallback from the card to the plain version.

Both compute the reference path's function (exact ``top_k`` over
‖q‖² + ‖r‖² − 2q·r with invalid refs at +inf), not the TPU kernel's
packed-key approximation. Ties keep the lower index in the kernel, as the
reference's ``top_k`` does; ``torch.topk`` in the plain version leaves the
order of equal distances open, so the two agree on distances and on
neighbour sets up to swaps between equal distances. Slots left at +inf hold
an in-range index (callers gather ``ref[idx]`` before masking).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from beam_slam_tpu_torch.ops import nvcc_build

SOURCES = ("knn.cu",)
KS = (1, 5, 8, 10)          # the k the kernel is instantiated for
CHUNK = 1024                # plain version: query rows per distance block


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set its C signature."""
    path, _, _ = nvcc_build.build("bst_knn", SOURCES)
    lib = ctypes.CDLL(str(path))
    fn = lib.bst_knn_topk_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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


def knn_topk_reference(query: torch.Tensor, ref: torch.Tensor,
                       ref_valid: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: matmul distances + ``torch.topk(largest=False)``, in blocks
    of ``CHUNK`` query rows (rows are independent, so blocking changes
    nothing but the peak memory)."""
    r_sq = torch.sum(ref * ref, dim=1)
    idx, d2 = [], []
    for qc in torch.split(query, CHUNK):
        d = (torch.sum(qc * qc, dim=1, keepdim=True) + r_sq[None, :]
             - 2.0 * qc @ ref.T)
        d = torch.where(ref_valid[None, :], d,
                        torch.full_like(d, float("inf")))
        v, i = torch.topk(d, k, dim=1, largest=False)
        idx.append(i)
        d2.append(v)
    if not idx:
        return (torch.zeros((0, k), dtype=torch.int64, device=query.device),
                torch.zeros((0, k), dtype=query.dtype, device=query.device))
    return torch.cat(idx), torch.cat(d2)


def knn_topk(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid refs per query: (idx [Q,k] int64, d2 [Q,k] f32).
    query [Q,3] f32, ref [R,3] f32, ref_valid [R] bool, contiguous, 1 ≤ k ≤ R;
    on the card k must be one of ``KS``."""
    _check(query, ref, ref_valid, k)
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
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(),
                 idx.data_ptr(), d2.data_ptr(), Q, R, k, stream)
    if err != 0:
        raise RuntimeError(f"kNN kernel launch failed: cudaError {err}")
    knn_topk.launches += 1
    return idx, d2


knn_topk.launches = 0

"""Fixed-radius neighbourhood moments — kernel K3 of the port.

``radius_moments(query, ref, ref_valid, rad)`` gives, for every query point,
the count, centroid and centred scatter of the valid refs within ``rad``:
(n [Q], c [Q,3], S [Q,3,3]), the contract of the reference's
``lidar/registration.py::_radius_moments``. On a CUDA tensor the [Q,13] raw
moments [1, x, y, z, 9 outer products] come from the hand-written Hopper
kernel of ``csrc/moments.cu`` (replacing the TPU kernel
``beam_slam_tpu/ops/pallas_moments.py::radius_moments``), on K2's grid: a
thread-block cluster of S CTAs per 32 queries, R split over its warps, S
chosen by :func:`beam_slam_tpu_torch.ops.knn.choose_cluster_size`; on a CPU
tensor from the plain version beside it, the reference's blocked-matmul
form. The finishing step (centroid, S = m2 − n·c cᵀ) is shared. A failing
build or launch raises: there is no fallback from the card to the plain
version.

Invalid refs stand at the reference's 1e5 sentinel on both paths (the
kernel counts them instead of scanning them). The kernel sums each part's
neighbours one by one in fp32 and then the parts, the matmul in blocks: n
agrees exactly, c to ~1e-6 relative, and S, the difference of two sums of
size n·‖r‖², to ~1e-6·n·max‖r‖² absolute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from beam_slam_tpu_torch.ops import nvcc_build
from beam_slam_tpu_torch.ops.knn import CLUSTER_SIZES, choose_cluster_size

SOURCES = ("moments.cu",)
SENTINEL = 1.0e5
CHUNK = 512                 # plain version: query rows per mask block


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set its C signature."""
    path, _, _ = nvcc_build.build("bst_moments", SOURCES)
    lib = ctypes.CDLL(str(path))
    fn = lib.bst_radius_moments_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bst_moments_max_active_clusters.argtypes = [ctypes.c_int]
    lib.bst_moments_max_active_clusters.restype = ctypes.c_int
    return lib


@functools.cache
def cluster_slots(device_index: int) -> Dict[int, int]:
    """Cluster size → clusters of the kernel the card holds at once (0
    where it cannot schedule the size), as the runtime reports it."""
    fn = load_library().bst_moments_max_active_clusters
    with torch.cuda.device(device_index):
        return {S: max(fn(S), 0) for S in CLUSTER_SIZES}


def _check(query, ref, ref_valid) -> None:
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
    if not (query.device == ref.device == ref_valid.device):
        raise ValueError(f"query on {query.device}, ref on {ref.device}, "
                         f"ref_valid on {ref_valid.device}")
    if not (query.is_contiguous() and ref.is_contiguous()
            and ref_valid.is_contiguous()):
        raise ValueError("query, ref and ref_valid must be contiguous")


def finish(mom: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[Q,13] raw moments → (n [Q], centroid [Q,3], centred scatter
    [Q,3,3]); an empty neighbourhood gives n = 0 and finite zeros."""
    n = mom[:, 0]
    safe_n = torch.clamp(n, min=1.0)
    c = mom[:, 1:4] / safe_n[:, None]
    S = (mom[:, 4:13].reshape(-1, 3, 3)
         - safe_n[:, None, None] * (c[:, :, None] * c[:, None, :]))
    return n, c, S


def raw_moments_reference(query: torch.Tensor, ref: torch.Tensor,
                          ref_valid: torch.Tensor, rad: float
                          ) -> torch.Tensor:
    """Plain K3: the reference's blocked-matmul form, W @ [1, r, r rᵀ] with
    the [CHUNK, R] mask W built per block of query rows → [Q,13]."""
    R3 = torch.where(ref_valid[:, None], ref,
                     torch.full_like(ref, SENTINEL))
    r_sq = torch.sum(R3 * R3, dim=1)
    outer9 = (R3[:, :, None] * R3[:, None, :]).reshape(-1, 9)
    aug = torch.cat([torch.ones_like(R3[:, :1]), R3, outer9], dim=1)
    rad2 = rad * rad
    out = [((torch.sum(qc * qc, dim=1, keepdim=True) + r_sq[None, :]
             - 2.0 * qc @ R3.T) < rad2).to(aug.dtype) @ aug
           for qc in torch.split(query, CHUNK)]
    if not out:
        return torch.zeros((0, 13), dtype=query.dtype, device=query.device)
    return torch.cat(out)


def radius_moments_reference(query, ref, ref_valid, rad: float):
    """Plain K3 with the shared finishing step: (n, c, S)."""
    return finish(raw_moments_reference(query, ref, ref_valid, rad))


def raw_moments(query: torch.Tensor, ref: torch.Tensor,
                ref_valid: torch.Tensor, rad: float,
                cluster: Optional[int] = None) -> torch.Tensor:
    """[Q,13] raw moments of each query's radius-``rad`` neighbourhood: the
    kernel on a CUDA tensor, the plain version on a CPU tensor. ``cluster``
    overrides the number of CTAs that split R for each 32 queries (a
    measurement knob; the default is K2's rule on this kernel's limits)."""
    _check(query, ref, ref_valid)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    rad = float(rad)
    if query.device.type == "cpu":
        return raw_moments_reference(query, ref, ref_valid, rad)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    Q, R = query.shape[0], ref.shape[0]
    mom = torch.empty((Q, 13), dtype=torch.float32, device=query.device)
    if Q == 0:
        return mom
    fn = load_library().bst_radius_moments_f32
    if cluster is None:
        dev = query.device.index
        cluster = choose_cluster_size(
            Q, cluster_slots(dev),
            torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(),
                 mom.data_ptr(), Q, R, rad * rad, cluster, stream)
    if err != 0:
        raise RuntimeError(f"moments kernel launch failed: cudaError {err}")
    raw_moments.launches += 1
    return mom


raw_moments.launches = 0


def radius_moments(query: torch.Tensor, ref: torch.Tensor,
                   ref_valid: torch.Tensor, rad: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n [Q], centroid [Q,3], centred scatter S [Q,3,3]) of each query's
    fixed-radius neighbourhood. query [Q,3] f32, ref [R,3] f32, ref_valid
    [R] bool, contiguous; ``rad`` a Python float."""
    return finish(raw_moments(query, ref, ref_valid, rad))

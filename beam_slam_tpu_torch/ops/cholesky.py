"""Batched Cholesky factor + solve — kernel K1 of the port.

``cholesky_solve_batched(H, g)`` solves H x = g for B damped, equilibrated
SPD systems. On a CUDA tensor it launches the hand-written Hopper kernel of
``csrc/cholesky.cu`` (replacing the TPU kernel
``beam_slam_tpu/ops/pallas_cholesky.py::cholesky_solve_batched``); on a CPU
tensor it takes the plain PyTorch version beside it. A failing build or
launch raises: there is no fallback from the card to the plain version.

Unlike the TPU kernel, a non-positive pivot is not clamped: ``info`` gets
the 1-based index of the first bad pivot and that system's x is NaN, as the
XLA cholesky path gives the reference's single-window solve.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from beam_slam_tpu_torch.ops import nvcc_build

SOURCES = ("cholesky.cu",)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; set its C signature."""
    path, _, _ = nvcc_build.build("bst_cholesky", SOURCES)
    lib = ctypes.CDLL(str(path))
    fn = lib.bst_cholesky_solve_batched_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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


def cholesky_solve_batched(H: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve H x = g. H: [B, N, N] f32 SPD, g: [B, N] f32, contiguous, any
    N ≥ 1. Returns (x [B, N] f32, info [B] int32: 0, or the 1-based index of
    the first non-positive pivot, in which case x[b] is NaN)."""
    _check(H, g)
    if H.device.type == "cpu":
        return cholesky_solve_batched_reference(H, g)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    fn = load_library().bst_cholesky_solve_batched_f32
    B, N = g.shape
    scratch = torch.empty_like(H)
    x = torch.empty_like(g)
    info = torch.empty(B, dtype=torch.int32, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(H.data_ptr(), g.data_ptr(), scratch.data_ptr(), x.data_ptr(),
                 info.data_ptr(), B, N, stream)
    if err != 0:
        raise RuntimeError(f"cholesky kernel launch failed: cudaError {err}")
    cholesky_solve_batched.launches += 1
    return x, info


cholesky_solve_batched.launches = 0

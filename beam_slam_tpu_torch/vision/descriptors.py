"""Binary feature descriptors + matching (port of
:mod:`beam_slam_tpu.vision.descriptors`).

Replacement for the reference's ORB descriptor usage (VisualFeatureTracker
extracts ORB descriptors — bs_models/src/visual_feature_tracker.cpp;
VisualOdometry matches them during local-map search, and the ImageDatabase
builds bag-of-words queries).

Design: BRIEF-style binary tests on a fixed pseudo-random pattern, batched
over keypoints with bilinear sampling; descriptors packed into 32-bit words
(int32 tensors holding the reference's uint32 bit patterns:
:func:`words_from_numpy` / :func:`words_to_numpy` convert); Hamming
distances via XOR and a popcount as one [N, M] batched op. Rotation
invariance comes from steering the pattern by the patch's
intensity-centroid orientation (the ORB construction). Everything runs on
the image's device.

The sampling pattern is the reference's ``jax.random.normal(PRNGKey(7))``
draw, which PyTorch cannot redraw, shipped as data beside this module
(``descriptors_pattern.npy``, [N_BITS, 2, 2] float32), written once with
the JAX package::

    import numpy as np
    from beam_slam_tpu.vision import descriptors
    np.save("descriptors_pattern.npy",
            np.asarray(descriptors._pattern(), np.float32))

tests/test_torch_descriptors.py holds the file equal to that draw.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.vision.tracker import _bilinear

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_R = 12.0
PATTERN_FILE = Path(__file__).with_name("descriptors_pattern.npy")


def _pattern(points) -> torch.Tensor:
    """Fixed BRIEF sampling pattern [N_BITS, 2, 2] (pairs of (x, y)) from
    the pattern's points, clipped to the patch as the reference clips its
    draw."""
    return torch.clamp(torch.as_tensor(points, dtype=torch.float32),
                       -PATCH_R, PATCH_R)


@functools.lru_cache(maxsize=None)
def _pattern_on(device: torch.device) -> torch.Tensor:
    return _pattern(np.load(PATTERN_FILE)).to(device)


def words_from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words [..., W] → int32 tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.as_tensor(a.copy(), device=device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor of words → uint32 numpy of the same bits."""
    return words.cpu().numpy().astype(np.int32).view(np.uint32)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., W·32] {0, 1} → [..., W] int32 words, bit b of word w from
    bits[..., 32·w + b] (the reference's ``sum(bits << arange(32))``)."""
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(b << shifts, dim=-1)                  # in [0, 2³²)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words → [..., W·32] int64 bits {0, 1}."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 in, int64 out)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def orientations(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (ORB): angle of the
    first-moment vector over a circular patch."""
    r = int(PATCH_R)
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=image.device)
    dy, dx = torch.meshgrid(ax, ax, indexing="ij")
    mask = ((dx * dx + dy * dy) <= r * r).to(image.dtype)
    offs = torch.stack([dx, dy], dim=-1)                     # [P, P, 2]
    patch = _bilinear(image, xy[:, None, None, :] + offs) * mask
    m10 = torch.sum(patch * dx, dim=(-2, -1))
    m01 = torch.sum(patch * dy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def compute(image: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptors for keypoints xy [N,2] on image [H,W].
    Returns (desc [N, N_WORDS] int32 words, ok [N])."""
    image = image.to(torch.float32)
    H, W = image.shape
    th = orientations(image, xy)
    c, s = torch.cos(th), torch.sin(th)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    pat = torch.einsum("nij,bpj->nbpi", R, _pattern_on(image.device))
    pa = xy[:, None, :] + pat[:, :, 0]
    pb = xy[:, None, :] + pat[:, :, 1]
    bits = _bilinear(image, pa) < _bilinear(image, pb)       # [N, N_BITS]
    desc = _pack(bits)
    m = PATCH_R + 2
    inb = ((xy[:, 0] >= m) & (xy[:, 0] < W - m)
           & (xy[:, 1] >= m) & (xy[:, 1] < H - m))
    return desc, valid & inb


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances: a [N, W] × b [M, W] → [N, M] int32."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def match(desc_a, valid_a, desc_b, valid_b, max_distance: int = 64,
          ratio: float = 0.8):
    """Mutual-nearest matching with Lowe's ratio test.
    Returns (idx_b_for_a [N] int32, good [N] bool)."""
    d = hamming_matrix(desc_a, desc_b)
    big = N_BITS + 1
    d = torch.where(valid_a[:, None] & valid_b[None, :], d,
                    torch.full_like(d, big))
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best] = big
    second_d = torch.min(d2, dim=1).values
    back = torch.argmin(d, dim=0)
    mutual = back[best] == rows
    good = (valid_a & mutual & (best_d <= max_distance)
            & (best_d.to(torch.float32)
               < ratio * second_d.to(torch.float32)))
    return best.to(torch.int32), good

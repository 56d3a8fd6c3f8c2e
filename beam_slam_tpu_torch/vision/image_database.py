"""Bag-of-binary-words image database (port of
:mod:`beam_slam_tpu.vision.image_database`).

Replaces the reference's beam_cv ``ImageDatabase`` (DBoW-backed; used by
VisualOdometry's local-map word search and by reloc requests): binary
descriptors are quantized against a vocabulary by Hamming distance (one
batched popcount op), frames are tf-idf weighted word histograms, and
queries are cosine similarities over the whole database.

Vocabulary tiers:

* random words (default, zero training) — adequate for revisit detection
  on distinctive scenes. The default (``n_words=256``, ``seed=11``) is the
  reference's ``jax.random.bits(PRNGKey(11))`` draw, which PyTorch cannot
  redraw, shipped as data beside this module
  (``image_database_vocab.npy``, [256, 8] uint32), written once with the
  JAX package::

      import numpy as np
      from beam_slam_tpu.vision.image_database import ImageDatabase
      np.save("image_database_vocab.npy",
              np.asarray(ImageDatabase().vocab))

  Any other ``(n_words, seed)`` is drawn from a ``torch.Generator`` seeded
  with ``seed``: the same kind of vocabulary, not the reference's words;
* **trained** (:func:`train_vocabulary`): binary k-means over corpus
  descriptors — Hamming assignment via one ±1 matmul, centroid update by
  per-bit majority vote — the flat counterpart of DBoW2's
  hierarchical-k-means descriptor clustering. Its first centre is an index
  the caller may give (the reference draws it with ``jax.random.choice``;
  the port, when not given, from a ``torch.Generator`` of ``seed``).

Vocabulary files (``np.savez`` of a uint32 ``vocab``) are the reference's:
a file saved by either package loads in the other. Words are int32 tensors
holding the uint32 bits (:mod:`.descriptors`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.vision import descriptors as desc_mod

N_BITS = desc_mod.N_WORDS * 32
DEFAULT_VOCAB_FILE = Path(__file__).with_name("image_database_vocab.npy")
DEFAULT_N_WORDS, DEFAULT_SEED = 256, 11


def _unpack_bits(descs: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 words → [N, W·32] float32 in {0, 1}."""
    return desc_mod._unpack(descs).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[M, W·32] bool → [M, W] int32 words."""
    return desc_mod._pack(bits)


def _kmeans_binary(bits: torch.Tensor, valid: torch.Tensor, first: int,
                   n_words: int, n_iters: int) -> torch.Tensor:
    """Binary k-means. bits [N, B] float {0,1}; returns centroids [K, B]
    bool. Hamming distance through one matmul: with s = 2·bits−1 ∈ {±1},
    d(x, c) = (B − s_x·s_c)/2 — so argmin Hamming = argmax s_x @ s_cᵀ.
    ``first`` is the index of the first centre (a valid row)."""
    N, B = bits.shape
    vf = valid.to(torch.float32)
    s_x = (2.0 * bits - 1.0) * vf[:, None]  # invalid rows → 0 (inert)

    # init: farthest-point (maximin) sampling — one center per descriptor
    # mode, immune to the merged-prototype local optima of random init
    neg = torch.full((N,), -float("inf"), device=bits.device)
    centers = torch.zeros((n_words, B), dtype=torch.float32,
                          device=bits.device)
    centers[0] = bits[first]
    dmin = torch.where(valid, torch.full_like(neg, float("inf")), neg)
    for k in range(1, n_words):
        s_c = 2.0 * centers[k - 1] - 1.0
        d = 0.5 * (B - s_x @ s_c)               # Hamming to newest center
        dmin = torch.minimum(dmin, torch.where(valid, d, neg))
        centers[k] = bits[torch.argmax(dmin)]

    for _ in range(n_iters):
        s_c = 2.0 * centers - 1.0
        sim = s_x @ s_c.T                       # [N, K]
        assign = torch.argmax(sim, dim=1)
        oh = torch.nn.functional.one_hot(assign, n_words).to(
            torch.float32) * vf[:, None]
        counts = oh.sum(dim=0)                  # [K]
        sums = oh.T @ bits                      # [K, B]
        mean = sums / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, mean > 0.5,
                              centers > 0.5).to(torch.float32)
    return centers > 0.5


def _words(descs, device) -> torch.Tensor:
    """Descriptor words as an int32 tensor on ``device``: a tensor is moved,
    host uint32 words keep their bits."""
    if isinstance(descs, torch.Tensor):
        return descs.to(device=device, dtype=torch.int32)
    return desc_mod.words_from_numpy(descs, device)


def _first_index(valid: torch.Tensor, seed: int) -> int:
    """A valid row drawn uniformly from a ``torch.Generator`` of ``seed``."""
    idx = torch.nonzero(valid.cpu()).reshape(-1)
    gen = torch.Generator().manual_seed(seed)
    return int(idx[torch.randint(len(idx), (1,), generator=gen)])


def train_vocabulary(descs, valid, n_words: int = 256, n_iters: int = 12,
                     seed: int = 0, first: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Train a binary-BoW vocabulary from a corpus of descriptors.

    descs [N, W] words (a tensor runs on its device; host uint32 words on
    ``device``, the card unless given), valid [N] bool. ``first`` is the
    first centre's row; by default a valid row drawn with ``seed``. Returns
    vocab [n_words, W] int32 words — drop-in for
    ``ImageDatabase(vocab=...)``."""
    dev = descs.device if isinstance(descs, torch.Tensor) else \
        resolve(device)
    descs = _words(descs, dev)
    valid = torch.as_tensor(valid, device=dev).bool()
    if first is None:
        first = _first_index(valid, seed)
    centers = _kmeans_binary(_unpack_bits(descs), valid, int(first),
                             n_words, n_iters)
    return _pack_bits(centers)


def _random_vocab(n_words: int, seed: int, device) -> torch.Tensor:
    if (n_words, seed) == (DEFAULT_N_WORDS, DEFAULT_SEED):
        return desc_mod.words_from_numpy(np.load(DEFAULT_VOCAB_FILE), device)
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (n_words, desc_mod.N_WORDS),
                          generator=gen, dtype=torch.int64)
    return words.to(torch.int32).to(device)


class ImageDatabase:
    def __init__(self, n_words: int = DEFAULT_N_WORDS,
                 seed: int = DEFAULT_SEED,
                 vocab=None, device=None):
        if vocab is not None:
            dev = (vocab.device if isinstance(vocab, torch.Tensor)
                   and device is None else resolve(device))
            self.vocab = _words(vocab, dev)
            n_words = int(self.vocab.shape[0])
        else:
            self.vocab = _random_vocab(n_words, seed, resolve(device))
        self.device = self.vocab.device
        self.n_words = n_words
        self.frames: List[float] = []
        self._hists: List[np.ndarray] = []
        self.word_of: Dict[float, np.ndarray] = {}

    @classmethod
    def trained(cls, descs, valid, n_words: int = 256, n_iters: int = 12,
                seed: int = 0, first: Optional[int] = None,
                device=None) -> "ImageDatabase":
        """Build a database with a vocabulary trained on a corpus (the
        offline DBoW-vocabulary-creation step of the reference stack)."""
        return cls(vocab=train_vocabulary(descs, valid, n_words, n_iters,
                                          seed, first, device))

    def save_vocabulary(self, path: str):
        np.savez(path, vocab=desc_mod.words_to_numpy(self.vocab))

    @classmethod
    def from_vocabulary_file(cls, path: str, device=None) -> "ImageDatabase":
        return cls(vocab=np.load(path)["vocab"], device=device)

    def words_for(self, descs, valid) -> np.ndarray:
        d = desc_mod.hamming_matrix(_words(descs, self.device), self.vocab)
        w = torch.argmin(d, dim=1).cpu().numpy()
        return np.where(torch.as_tensor(valid).cpu().numpy(), w, -1)

    def _hist(self, words: np.ndarray) -> np.ndarray:
        h = np.bincount(words[words >= 0], minlength=self.n_words) \
            .astype(np.float64)
        n = np.linalg.norm(h)
        return h / n if n > 0 else h

    def add_frame(self, stamp: float, descs, valid):
        words = self.words_for(descs, valid)
        self.word_of[stamp] = words
        self.frames.append(stamp)
        self._hists.append(self._hist(words))

    def query(self, descs, valid, top_k: int = 3,
              exclude_recent: int = 1) -> List[Tuple[float, float]]:
        """Most similar database frames: [(stamp, cosine score)]."""
        if len(self.frames) <= exclude_recent:
            return []
        h = self._hist(self.words_for(descs, valid))
        H = np.stack(self._hists[: len(self._hists) - exclude_recent])
        scores = H @ h
        order = np.argsort(scores)[::-1][:top_k]
        return [(self.frames[i], float(scores[i])) for i in order]

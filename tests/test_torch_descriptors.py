"""Parity of the port's binary descriptors and image database
(beam_slam_tpu_torch.vision.descriptors / image_database) with the JAX
package on the CPU.

* The vendored data equal the reference's draws: the BRIEF pattern
  (``_pattern()``, PRNGKey(7)) and the default vocabulary
  (``ImageDatabase()``, PRNGKey(11)), bit for bit.
* ``compute`` / ``hamming_matrix`` / ``match`` against JAX on seeded
  textures (tests/test_descriptors.py's ``_textured``, numpy seeds 42 and
  1–3) and shifted views: ``ok`` equal, descriptor bits equal on ≥ 99.5%
  (a bit flips only where an orientation or a sample rounds differently),
  Hamming distances of the same words equal, matches equal.
* ``_kmeans_binary`` from the reference's first index (its
  ``jax.random.choice`` draw) gives the reference's centres; vocabulary
  files read both ways.
* The port's mirrors of the six tests of tests/test_descriptors.py.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from beam_slam_tpu.vision import descriptors as jdsc
from beam_slam_tpu.vision import detector as jdet
from beam_slam_tpu.vision import image_database as jidb
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.vision import descriptors as dsc
from beam_slam_tpu_torch.vision import detector as det
from beam_slam_tpu_torch.vision import image_database as tidb
from beam_slam_tpu_torch.vision.image_database import (ImageDatabase,
                                                       train_vocabulary)
from test_descriptors import _textured

torch.set_num_threads(2)

BIT_SHARE = 0.995
FAST = dict(threshold=10, cell_size=24)


def _detect(img):
    return det.detect(torch.as_tensor(img), det.FastConfig(**FAST))


def _words(desc):
    return dsc.words_to_numpy(desc)


def _bits(words_u32):
    return np.unpackbits(words_u32.view(np.uint8), bitorder="little")


def test_vendored_pattern_equals_reference_draw():
    ref = np.asarray(jdsc._pattern())
    np.testing.assert_array_equal(np.load(dsc.PATTERN_FILE), ref)
    np.testing.assert_array_equal(dsc._pattern(ref).numpy(), ref)
    np.testing.assert_array_equal(dsc._pattern_on(torch.device("cpu")),
                                  ref)


def test_vendored_vocabulary_equals_reference_draw():
    ref = np.asarray(jidb.ImageDatabase().vocab)
    np.testing.assert_array_equal(np.load(tidb.DEFAULT_VOCAB_FILE), ref)
    db = ImageDatabase(device="cpu")
    np.testing.assert_array_equal(_words(db.vocab), ref)
    # another (n_words, seed): a torch.Generator draw of that size
    other = ImageDatabase(n_words=64, seed=3, device="cpu")
    assert other.vocab.shape == (64, dsc.N_WORDS)
    torch.testing.assert_close(
        other.vocab, ImageDatabase(n_words=64, seed=3, device="cpu").vocab)


def test_word_conversions_keep_bits():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    t = bridge.vocabulary_from_numpy(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(dsc.words_to_numpy(t), w)
    bits = dsc._unpack(t)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jidb._unpack_bits(jnp.asarray(w))))
    np.testing.assert_array_equal(dsc.words_to_numpy(dsc._pack(bits)), w)
    np.testing.assert_array_equal(
        dsc.hamming_matrix(t, t).numpy(),
        np.asarray(jdsc.hamming_matrix(jnp.asarray(w), jnp.asarray(w))))


@pytest.mark.parametrize("seed", [42, 1, 2, 3])
def test_compute_and_match_against_reference(seed):
    img1 = _textured(np.random.default_rng(seed))
    img2 = ndimage.shift(img1, (4.0, -6.0), order=1, mode="nearest")
    xy_j, _, v_j = jdet.detect(jnp.asarray(img1), jdet.FastConfig(**FAST))
    xy_t, _, v_t = _detect(img1)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    shift = np.asarray([-6.0, 4.0], np.float32)
    out = {}
    for name, img in (("a", img1), ("b", img2)):
        xy = np.asarray(xy_j) + (shift if name == "b" else 0)
        d_j, ok_j = jdsc.compute(jnp.asarray(img), jnp.asarray(xy), v_j)
        d_t, ok_t = dsc.compute(torch.as_tensor(img), torch.as_tensor(xy),
                                v_t)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        sel = np.asarray(ok_j)
        wj, wt = np.asarray(d_j)[sel], _words(d_t)[sel]
        share = float((_bits(wj) == _bits(wt)).mean())
        assert share >= BIT_SHARE, share
        out[name] = (d_j, ok_j, d_t, ok_t)
    d_ja, ok_ja, d_ta, ok_ta = out["a"]
    d_jb, ok_jb, d_tb, ok_tb = out["b"]
    # the same words give the same distances
    np.testing.assert_array_equal(
        dsc.hamming_matrix(d_ta, d_tb).numpy(),
        np.asarray(jdsc.hamming_matrix(
            jnp.asarray(_words(d_ta)), jnp.asarray(_words(d_tb)))))
    idx_j, good_j = jdsc.match(d_ja, ok_ja, d_jb, ok_jb)
    idx_t, good_t = dsc.match(d_ta, ok_ta, d_tb, ok_tb)
    good = np.asarray(good_j)
    np.testing.assert_array_equal(good_t.numpy(), good)
    np.testing.assert_array_equal(idx_t.numpy()[good],
                                  np.asarray(idx_j)[good])
    # and the port's matcher on the reference's words answers the same
    idx_w, good_w = dsc.match(
        bridge.vocabulary_from_numpy(np.asarray(d_ja), "cpu"), ok_ta,
        bridge.vocabulary_from_numpy(np.asarray(d_jb), "cpu"), ok_tb)
    np.testing.assert_array_equal(good_w.numpy(), good)
    np.testing.assert_array_equal(idx_w.numpy(), np.asarray(idx_j))


def _corpus(seed=7, n_proto=32, per_proto=60, noise=0.03):
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 2 ** 32, (n_proto, 8), dtype=np.uint64) \
        .astype(np.uint32)
    corpus = np.repeat(protos, per_proto, axis=0)
    bitsel = rng.random((corpus.shape[0], 8, 32)) < noise
    flip = np.zeros_like(corpus)
    for b in range(32):
        flip |= (bitsel[:, :, b].astype(np.uint32) << b)
    return corpus ^ flip, rng


def test_kmeans_from_reference_first_index():
    corpus, _ = _corpus()
    valid = np.ones(len(corpus), bool)
    valid[::7] = False
    seed = 3
    vf = jnp.asarray(valid, jnp.float32)
    first = int(jax.random.choice(jax.random.PRNGKey(seed), len(corpus),
                                  p=vf / jnp.maximum(vf.sum(), 1.0)))
    ref = np.asarray(jidb.train_vocabulary(corpus, valid, n_words=32,
                                           n_iters=15, seed=seed))
    out = train_vocabulary(corpus, valid, n_words=32, n_iters=15,
                           seed=seed, first=first, device="cpu")
    np.testing.assert_array_equal(_words(out), ref)
    # without ``first`` the port draws a valid row of its own
    own = train_vocabulary(corpus, valid, n_words=8, n_iters=2, seed=seed,
                           device="cpu")
    assert own.shape == (8, 8)


def test_vocabulary_files_read_both_ways(tmp_path):
    corpus, _ = _corpus(seed=2, n_proto=8, per_proto=25)
    valid = np.ones(len(corpus), bool)
    db_t = ImageDatabase.trained(corpus, valid, n_words=16, n_iters=4,
                                 device="cpu")
    db_j = jidb.ImageDatabase.trained(jnp.asarray(corpus), valid,
                                      n_words=16, n_iters=4)
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    db_t.save_vocabulary(p_t)
    db_j.save_vocabulary(p_j)
    from_j = ImageDatabase.from_vocabulary_file(p_j, device="cpu")
    from_t = jidb.ImageDatabase.from_vocabulary_file(p_t)
    np.testing.assert_array_equal(_words(from_j.vocab), np.asarray(db_j.vocab))
    np.testing.assert_array_equal(np.asarray(from_t.vocab), _words(db_t.vocab))
    q = corpus[:40]
    np.testing.assert_array_equal(
        from_j.words_for(q, np.ones(40, bool)),
        db_j.words_for(jnp.asarray(q), jnp.ones(40, bool)))


# ---- the port's mirrors of tests/test_descriptors.py ----------------------


def test_descriptor_matching_under_shift(rng):
    img1 = _textured(rng)
    img2 = ndimage.shift(img1, (4.0, -6.0), order=1, mode="nearest")
    xy1, s1, v1 = _detect(img1)
    xy2 = xy1 + torch.tensor([-6.0, 4.0])
    d1, ok1 = dsc.compute(torch.as_tensor(img1), xy1, v1)
    d2, ok2 = dsc.compute(torch.as_tensor(img2), xy2, v1)
    idx, good = dsc.match(d1, ok1, d2, ok2)
    good = good.numpy()
    assert good.sum() >= 10
    assert (idx.numpy()[good] == np.nonzero(good)[0]).mean() > 0.9


def test_descriptor_distance_separates_random(rng):
    img = _textured(rng)
    xy, s, v = _detect(img)
    d, ok = dsc.compute(torch.as_tensor(img), xy, v)
    sel = np.nonzero(ok.numpy())[0][:20]
    D = dsc.hamming_matrix(d[sel], d[sel]).numpy()
    assert np.all(np.diag(D) == 0)
    off = D[~np.eye(len(sel), dtype=bool)]
    assert np.median(off) > 30, np.median(off)


def test_image_database_recognizes_revisit():
    db = ImageDatabase(n_words=128, device="cpu")
    imgs = [_textured(np.random.default_rng(s)) for s in (1, 2, 3)]
    for i, img in enumerate(imgs):
        xy, s, v = _detect(img)
        d, ok = dsc.compute(torch.as_tensor(img), xy, v)
        db.add_frame(float(i), d, ok)
    img_q = ndimage.shift(imgs[0], (2.0, 1.0), order=1, mode="nearest")
    xy, s, v = _detect(img_q)
    dq, okq = dsc.compute(torch.as_tensor(img_q), xy, v)
    res = db.query(dq, okq, top_k=1, exclude_recent=0)
    assert res and res[0][0] == 0.0, res


def _flip_bits(rng, words, share):
    bitsel = rng.random(words.shape + (32,)) < share
    flip = np.zeros_like(words)
    for b in range(32):
        flip |= (bitsel[..., b].astype(np.uint32) << b)
    return words ^ flip


def test_image_database_discriminates_revisits():
    rng = np.random.default_rng(4)
    n_places, n_desc = 20, 120
    db = ImageDatabase(n_words=256, device="cpu")
    places = []
    for pi in range(n_places):
        d = rng.integers(0, 2 ** 32, (n_desc, 8), dtype=np.uint64) \
            .astype(np.uint32)
        places.append(d)
        db.add_frame(float(pi), d, np.ones(n_desc, bool))
    hits = 0
    for pi in range(n_places):
        noisy = _flip_bits(rng, places[pi].copy(), 0.05)
        out = rng.random(n_desc) < 0.2
        noisy[out] = rng.integers(0, 2 ** 32, (int(out.sum()), 8),
                                  dtype=np.uint64).astype(np.uint32)
        res = db.query(noisy, np.ones(n_desc, bool), top_k=1,
                       exclude_recent=0)
        if res and int(res[0][0]) == pi:
            hits += 1
    assert hits >= 18, hits


def test_trained_vocabulary_beats_random_quantization():
    n_proto, per_proto = 32, 60
    corpus, rng = _corpus(seed=7, n_proto=n_proto, per_proto=per_proto)
    valid = np.ones(corpus.shape[0], bool)
    vocab = train_vocabulary(corpus, valid, n_words=n_proto, n_iters=15,
                             seed=3, device="cpu")
    c_t = bridge.vocabulary_from_numpy(corpus, "cpu")

    def mean_quant_err(voc):
        return dsc.hamming_matrix(c_t, voc).numpy().min(axis=1).mean()

    err_trained = mean_quant_err(vocab)
    err_random = mean_quant_err(ImageDatabase(n_words=n_proto,
                                              device="cpu").vocab)
    assert err_trained < 15, err_trained
    assert err_trained < 0.25 * err_random, (err_trained, err_random)

    db = ImageDatabase(vocab=vocab)
    n_places = 8
    place_descs = []
    for pi in range(n_places):
        sel = rng.choice(n_proto, 4, replace=False)
        d = corpus[np.concatenate([np.arange(s * per_proto,
                                             s * per_proto + 30)
                                   for s in sel])]
        place_descs.append(d)
        db.add_frame(float(pi), d, np.ones(len(d), bool))
    hits = 0
    for pi in range(n_places):
        noisy = _flip_bits(rng, place_descs[pi].copy(), 0.05)
        res = db.query(noisy, np.ones(len(noisy), bool), top_k=1,
                       exclude_recent=0)
        if res and int(res[0][0]) == pi:
            hits += 1
    assert hits == n_places, hits


def test_vocabulary_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    descs = rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint64) \
        .astype(np.uint32)
    db = ImageDatabase.trained(descs, np.ones(200, bool), n_words=16,
                               n_iters=4, device="cpu")
    path = str(tmp_path / "vocab.npz")
    db.save_vocabulary(path)
    db2 = ImageDatabase.from_vocabulary_file(path, device="cpu")
    assert torch.equal(db.vocab, db2.vocab)
    w1 = db.words_for(descs[:10], np.ones(10, bool))
    w2 = db2.words_for(descs[:10], np.ones(10, bool))
    assert np.array_equal(w1, w2)

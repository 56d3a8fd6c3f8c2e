"""JAX-side results recorded under tests/data/, for parity tests whose JAX
session costs minutes of CPU compile and run: the encoding, and its tests.

A test compares the port with the recording; a ``slow`` test of the same
file runs the JAX session again and holds it to the recording, and the
file's ``record`` entry point rewrites it (``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_<name>.py record``).

The encoding is gzipped JSON: arrays with their dtype and shape (float32
values are exact as JSON floats), dicts as key-value pairs (keys may be
floats, ints, tuples or None), tuples and sets tagged.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

DATA = Path(__file__).resolve().parent / "data"


def encode(x):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {"dict": [[encode(k), encode(v)] for k, v in x.items()]}
    if isinstance(x, list):
        return [encode(v) for v in x]
    if isinstance(x, tuple):
        return {"tuple": [encode(v) for v in x]}
    if isinstance(x, (set, frozenset)):
        return {"set": [encode(v) for v in sorted(x)]}
    if isinstance(x, (np.bool_, np.integer, np.floating)):
        return x.item()
    a = np.asarray(x)   # numpy and JAX arrays
    return {"nd": a.ravel().tolist(), "dtype": str(a.dtype),
            "shape": list(a.shape)}


def decode(x):
    if isinstance(x, list):
        return [decode(v) for v in x]
    if not isinstance(x, dict):
        return x
    if "nd" in x:
        return np.asarray(x["nd"], dtype=x["dtype"]).reshape(x["shape"])
    if "dict" in x:
        return {_key(decode(k)): decode(v) for k, v in x["dict"]}
    if "tuple" in x:
        return tuple(decode(v) for v in x["tuple"])
    return {decode(v) for v in x["set"]}


def _key(k):
    return tuple(k) if isinstance(k, list) else k


def save(name: str, obj) -> Path:
    path = DATA / f"{name}.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(encode(obj), f)
    return path


def load(name: str):
    with gzip.open(DATA / f"{name}.json.gz", "rt") as f:
        return decode(json.load(f))


def encode_roundtrip(obj):
    """``obj`` as its recording would give it back (tuples, float keys and
    array dtypes as stored)."""
    return decode(json.loads(json.dumps(encode(obj))))


def assert_same(live, recorded, path="", rtol=1e-5, atol=1e-6):
    """A live JAX result against its recording: the same structure, equal
    scalars and strings, arrays within rtol / atol (XLA's CPU code may
    round differently on another host)."""
    if isinstance(recorded, dict):
        assert isinstance(live, dict) and set(live) == set(recorded), path
        for k in recorded:
            assert_same(live[k], recorded[k], f"{path}/{k}", rtol, atol)
    elif isinstance(recorded, (list, tuple)):
        assert len(live) == len(recorded), path
        for i, (a, b) in enumerate(zip(live, recorded)):
            assert_same(a, b, f"{path}[{i}]", rtol, atol)
    elif isinstance(recorded, np.ndarray):
        np.testing.assert_allclose(np.asarray(live), recorded, rtol=rtol,
                                   atol=atol, err_msg=path)
    elif isinstance(recorded, float):
        np.testing.assert_allclose(float(live), recorded, rtol=rtol,
                                   atol=atol, err_msg=path)
    else:
        assert live == recorded, (path, live, recorded)


# ---- the encoding's own tests

RECORDINGS = {
    "global_mapper_jax": {"out", "submaps", "candidates", "refinements"},
    "local_mapper_lio_jax": {"sync", "async", "frameinit"},
    "lvio_session_jax": {"recs", "init", "lidar"},
    "sharded_mesh_jax": {"p", "final_cost"},
    "smoother_session_jax": {"sync", "async 0 0", "async 2 2"},
    "vio_session_jax": {"recs", "init", "lidar"},
    "visual_odometry_jax": {"EUC", "IDP"}}


def test_round_trip_keeps_values_and_types():
    rng = np.random.default_rng(0)
    obj = {
        0.1: rng.standard_normal((3, 4)).astype(np.float32),
        2: np.arange(5, dtype=np.int32), None: np.zeros((0, 3), np.float64),
        (1.5, 2.5): [np.bool_(True), np.float32(0.25), {"s", "t"}],
        "nan": float("nan"), "scalar": np.array(7.0, np.float32),
        "nested": ({"a": [1, 2.0, None]}, "text")}
    back = encode_roundtrip(obj)
    assert set(back) == set(obj)
    for k in (0.1, 2, None, "scalar"):
        assert back[k].dtype == obj[k].dtype
        assert back[k].shape == obj[k].shape
        np.testing.assert_array_equal(back[k], obj[k])
    assert back[(1.5, 2.5)] == [True, 0.25, {"s", "t"}]
    assert back["nan"] != back["nan"]
    assert back["nested"] == ({"a": [1, 2.0, None]}, "text")


def test_assert_same_holds_within_tolerance_only():
    a = {"x": np.array([1.0, 2.0], np.float32), "n": 3, "f": 0.5}
    assert_same({"x": a["x"] * (1 + 1e-7), "n": 3, "f": 0.5}, a)
    for live in ({"x": a["x"] + 1e-3, "n": 3, "f": 0.5},
                 {"x": a["x"], "n": 4, "f": 0.5},
                 {"x": a["x"], "n": 3}):
        with pytest.raises(AssertionError):
            assert_same(live, a)


@pytest.mark.parametrize("name", sorted(RECORDINGS))
def test_recording_loads(name):
    assert set(load(name)) == RECORDINGS[name]

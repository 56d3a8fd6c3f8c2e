"""Parity of the port's IMU preintegration (beam_slam_tpu_torch.imu.
preintegration) with the JAX reference: the device path's ``predict_state``
and ``compute_information=False``, the host-numpy mirrors
(``preintegrate_np``, ``sqrt_inv_cov_np``, ``predict_state_np``) against the
reference's mirrors, and both port paths against the float64 oracle of
tests/test_preintegration.py (a literal transcription of the reference's
Increment math), at that file's bounds.

Inputs: the reference's analytic trajectory sampled at 200 Hz (exact IMU),
plus gyro/accel biases and noise drawn from a numpy seed.

Tolerances: the numpy mirrors run in float64 on both sides (the reference's
backend-dual lie module takes its numpy path there) and round to float32 at
the end, so 1e-6 of scale; the torch path is float32 against JAX's float32
scan, the same math in another order, so 2e-5 of scale (rtol 1e-4); the
whitener amplifies by the covariance's condition, so 1e-4 of its scale.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.imu import preintegration as jpre
from beam_slam_tpu.utils import sim as jsim
from beam_slam_tpu_torch.imu import preintegration as tpre

from test_preintegration import OraclePreintegrator

torch.set_num_threads(2)

RATE = 200.0
SIGMAS = (1e-3, 1e-2, 1e-5, 1e-4)
FIELDS = ("t", "q", "p", "v", "cov", "sqrt_inv_cov", "dq_dbg", "dp_dbg",
          "dp_dba", "dv_dbg", "dv_dba")


def _close(out, ref, rel, name="", rtol=1e-4):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, name
    scale = max(1.0, float(np.abs(ref).max()))
    npt.assert_allclose(out, ref, atol=rel * scale, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def stream():
    """(dt [N], w [N,3], a [N,3], bg, ba, q_i, p_i, v_i) as numpy, float32."""
    rng = np.random.default_rng(5)
    s = jsim.imu_measurements(jsim.AnalyticTrajectory(), 0.0, 0.6, RATE)
    n = len(np.asarray(s.t)) - 1
    f32 = np.float32
    w = (np.asarray(s.w_body)[:-1] + 1e-3 * rng.standard_normal((n, 3)))
    a = (np.asarray(s.a_body)[:-1] + 1e-2 * rng.standard_normal((n, 3)))
    q_i = rng.standard_normal(4)
    q_i[0] = abs(q_i[0]) + 1.0
    return dict(dt=np.full(n, 1.0 / RATE, f32), w=w.astype(f32),
                a=a.astype(f32),
                bg=np.array([0.02, -0.01, 0.015], f32),
                ba=np.array([0.1, -0.05, 0.08], f32),
                q_i=(q_i / np.linalg.norm(q_i)).astype(f32),
                p_i=rng.standard_normal(3).astype(f32),
                v_i=rng.standard_normal(3).astype(f32))


def _noises():
    return (jpre.PreintNoise.isotropic(*SIGMAS),
            tpre.PreintNoise.isotropic(*SIGMAS))


def _device_pair(st, compute_information=True):
    nj, nt = _noises()
    ref = jpre.preintegrate(*(jnp.asarray(st[k]) for k in
                              ("dt", "w", "a", "bg", "ba")), nj,
                            compute_information=compute_information)
    out = tpre.preintegrate(*(torch.from_numpy(st[k]) for k in
                              ("dt", "w", "a", "bg", "ba")), nt,
                            compute_information=compute_information)
    return ref, out


@pytest.mark.parametrize("info", [True, False], ids=["info", "no_info"])
def test_device_path_matches_reference(stream, info):
    ref, out = _device_pair(stream, compute_information=info)
    for f in FIELDS:
        _close(getattr(out, f), getattr(ref, f),
               1e-4 if f == "sqrt_inv_cov" else 2e-5, f)
    if not info:
        assert not bool(out.sqrt_inv_cov.any())


def test_predict_state_matches_reference(stream):
    ref, out = _device_pair(stream)
    st = stream
    qj, pj, vj = jpre.predict_state(ref, *(jnp.asarray(st[k]) for k in
                                           ("q_i", "p_i", "v_i")))
    qt, pt, vt = tpre.predict_state(out, *(torch.from_numpy(st[k]) for k in
                                           ("q_i", "p_i", "v_i")))
    for name, a, b in (("q", qt, qj), ("p", pt, pj), ("v", vt, vj)):
        _close(a, b, 2e-5, name)


@pytest.mark.parametrize("info", [True, False], ids=["info", "no_info"])
def test_numpy_mirrors_match_reference(stream, info):
    st = stream
    nj, nt = _noises()
    args = [st[k] for k in ("dt", "w", "a", "bg", "ba")]
    ref = jpre.preintegrate_np(*args, nj, compute_information=info)
    out = tpre.preintegrate_np(*args, nt, compute_information=info)
    for f in FIELDS:
        assert np.asarray(getattr(out, f)).dtype == np.float32, f
        _close(getattr(out, f), getattr(ref, f), 1e-6, f, rtol=1e-5)
    _close(tpre.sqrt_inv_cov_np(out.cov), jpre.sqrt_inv_cov_np(ref.cov),
           1e-6, "sqrt_inv_cov_np", rtol=1e-5)
    for a, b in zip(tpre.predict_state_np(out, st["q_i"], st["p_i"],
                                          st["v_i"]),
                    jpre.predict_state_np(ref, st["q_i"], st["p_i"],
                                          st["v_i"])):
        _close(a, b, 1e-6, "predict_state_np", rtol=1e-5)


def test_sqrt_inv_cov_np_floors_and_fallback():
    """The degeneracy floors on a zero covariance, and the fallback weight
    on an indefinite one, as the reference's mirror gives them."""
    zero = np.zeros((15, 15))
    bad = -np.eye(15)
    for cov in (zero, bad):
        npt.assert_array_equal(tpre.sqrt_inv_cov_np(cov),
                               jpre.sqrt_inv_cov_np(cov))


def _oracle(st):
    cov = [s * s * np.eye(3) for s in SIGMAS]
    o = OraclePreintegrator(*cov)
    for i in range(len(st["dt"])):
        o.increment(float(st["dt"][i]), st["w"][i].astype(np.float64),
                    st["a"][i].astype(np.float64),
                    st["bg"].astype(np.float64), st["ba"].astype(np.float64))
    return o


@pytest.mark.parametrize("path", ["device", "numpy"])
def test_matches_f64_oracle(stream, path):
    """tests/test_preintegration.py::test_matches_f64_oracle's bounds, on
    the port's torch path and its numpy mirror, with nonzero biases."""
    o = _oracle(stream)
    if path == "device":
        d = _device_pair(stream)[1]
        d = tpre.Delta(*(getattr(d, f).numpy() for f in FIELDS))
    else:
        nt = _noises()[1]
        d = tpre.preintegrate_np(*(stream[k] for k in
                                   ("dt", "w", "a", "bg", "ba")), nt)
    q_o = o.q.as_quat()
    q_o = np.concatenate([q_o[3:4], q_o[:3]])
    assert abs(abs(np.dot(q_o, np.asarray(d.q))) - 1.0) < 1e-6
    npt.assert_allclose(d.p, o.p, atol=1e-4)
    npt.assert_allclose(d.v, o.v, atol=1e-4)
    npt.assert_allclose(d.t, o.t, atol=1e-6)
    npt.assert_allclose(d.dq_dbg, o.dq_dbg, rtol=1e-3, atol=1e-4)
    npt.assert_allclose(d.dv_dba, o.dv_dba, rtol=1e-3, atol=1e-4)
    npt.assert_allclose(d.dp_dbg, o.dp_dbg, rtol=2e-3, atol=1e-4)
    npt.assert_allclose(d.dp_dba, o.dp_dba, rtol=2e-3, atol=1e-4)
    c = np.asarray(d.cov, np.float64)
    assert np.linalg.norm(c - o.cov) / np.linalg.norm(o.cov) < 1e-3

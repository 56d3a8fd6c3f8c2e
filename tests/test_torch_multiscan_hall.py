"""The JAX package's MultiScan factors on phase 14a's inputs (chip_smoke.py:
the hall at 16 × 1800 from MULTISCAN_SCANS poses, seeds perturbed by numpy
seed MULTISCAN_SEED) for the matchers whose factors miss their bounds of
the truth in the JAX package as in the port: ICP (0.1 m, worst 0.177 m)
and NDT (0.15 m / 0.02 rad, worst 0.168 m / 0.028 rad). chip_smoke.py
holds the card to these factors, kept in tests/data/multiscan_hall_jax.json,
instead of the truth (ROADMAP Queue 3). This file checks that the JSON is
the JAX package's output; tests/test_torch_multiscan_hall_port.py holds
the port's CPU plain path to it.

    python tests/test_torch_multiscan_hall.py   # rewrites the JSON

Tolerance: the JAX package against its JSON within 2e-4 m / 2e-4 rad
(XLA's CPU code differs by machine in the last bits, repeated over 15 GN
steps).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (its inputs; it imports no JAX)

torch.set_num_threads(2)

JSON = os.path.join(ROOT, "tests", "data", "multiscan_hall_jax.json")
HELD = ("icp", "ndt")
JAX_TOL = 2e-4


def hall_factors(package: str, name: str) -> list:
    """[(i, j, dq, dp)] of the MultiScan strategy of ``package`` ("jax" or
    "port", on the CPU) with matcher ``name`` over phase 14a's scans."""
    poses = cs._multiscan_poses(cs.MULTISCAN_SCANS)
    rng = np.random.default_rng(cs.MULTISCAN_SEED)
    seeds = [poses[0]] + [cs._perturbed(q, p, rng) for q, p in poses[1:]]
    stamps = [0.1 * i for i in range(cs.MULTISCAN_SCANS)]
    grids = [cs._hall_grid(q, p, "cpu", cs.WIDTH, seed=100 + i)
             for i, (q, p) in enumerate(poses)]
    args = (cs.MULTISCAN_JSON, f"matchers/{name}.json")
    if package == "jax":
        import jax.numpy as jnp
        from beam_slam_tpu.lidar import cloud as jcloud
        from beam_slam_tpu.lidar import scan_registration as jsr
        from beam_slam_tpu.solver.smoother import Transaction
        st, _ = jsr.create_scan_registration(
            *args, config_root=os.path.join(ROOT, "configs"))
        grids = [jcloud.RingGrid(*(jnp.asarray(getattr(g, f).numpy())
                                   for f in ("xyz", "time", "valid")))
                 for g in grids]
        seeds = [(jnp.asarray(q), jnp.asarray(p)) for q, p in seeds]
    else:
        from beam_slam_tpu_torch.lidar import scan_registration as tsr
        from beam_slam_tpu_torch.solver.smoother import Transaction
        st, _ = tsr.create_scan_registration(
            *args, config_root=os.path.join(ROOT, "configs"), device="cpu")
    out = []
    for i in range(cs.MULTISCAN_SCANS):
        txn = Transaction(stamp=stamps[i])
        assert st.register_new_scan(stamps[i], None, *seeds[i], txn,
                                    grid=grids[i]), (package, name, i)
        out += [(stamps.index(f.stamp_i), i,
                 np.asarray(f.dq, np.float64).tolist(),
                 np.asarray(f.dp, np.float64).tolist())
                for f in txn.rel_poses]
    return out


def _held():
    with open(JSON) as f:
        return json.load(f)


def _gaps(factors, ref):
    assert [(i, j) for i, j, _, _ in factors] == [(i, j) for i, j, _, _ in
                                                 ref]
    return (max(float(np.linalg.norm(np.subtract(a[3], b[3])))
                for a, b in zip(factors, ref)),
            max(cs._so3_err(np.asarray(a[2], np.float32),
                            np.asarray(b[2], np.float32))
                for a, b in zip(factors, ref)))


@pytest.mark.parametrize("name", HELD)
def test_json_is_the_jax_packages_factors(name):
    dp, dr = _gaps(hall_factors("jax", name), _held()[name])
    assert dp < JAX_TOL and dr < JAX_TOL, (name, dp, dr)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (JAX on the CPU)
    out = {name: hall_factors("jax", name) for name in HELD}
    with open(JSON, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {JSON}: " + ", ".join(f"{k} {len(v)} factors"
                                        for k, v in out.items()))

"""The batched LVIO-window system: the program's shared-topology batched
LM solve (``solver.batched.solve_batched_shared``) of B windows of one
census, held to the plain reference :mod:`benchmark.reference.lvio`.

One timed call solves the whole batch from the drawn initial guess:
``lm_steps`` LM steps (``scan_length``, no early exit), each assembling
every window's normal equations, Schur-eliminating the landmarks and
solving the B reduced systems in one K1 launch. Every timed call starts
from the same state, so every answer is compared with the one reference
solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from benchmark.reference import factors as ref_factors
from benchmark.reference import lie
from benchmark.reference import lvio as ref
from benchmark.reference import window as ref_window
from benchmark.traffic import lvio_windows as traffic

REF_BLOCK = 256   # windows the reference solves at once
BLOCKS = (("imu", "ImuStates"), ("extrinsics", "Poses"),
          ("landmarks", "Landmarks"), ("motion", "MotionStates"))


def _build(window_mod, factors_mod, window: Dict, families, cast=None):
    """(WindowState, families) of ``window_mod``/``factors_mod``'s types
    from the generator's plain leaves, field by field; ``cast`` maps every
    floating leaf (the reference's dtype)."""
    def fill(cls, leaves):
        return cls(**{f.name: (cast(leaves[f.name]) if cast is not None
                               and leaves[f.name].is_floating_point()
                               else leaves[f.name])
                      for f in dataclasses.fields(cls)})
    w = window_mod.WindowState(**{
        block: fill(getattr(window_mod, cls), window[block])
        for block, cls in BLOCKS})
    fams = tuple(fill(getattr(factors_mod, name), leaves)
                 for name, leaves in families)
    return w, fams


class System:
    """Set-up draws the batch from the seed and builds the program's window
    and families from it; :meth:`solve` enqueues one timed call and returns
    its answer."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        from beam_slam_tpu_torch.core import factors as fc
        from beam_slam_tpu_torch.core import window as win
        from beam_slam_tpu_torch.solver import batched
        from beam_slam_tpu_torch.solver import gauss_newton as gn
        self.batched = batched
        d = config["deployment"]
        self.B = int(mix["batch"])
        self.n_iter = int(mix["lm_steps"])
        self.tol = float(d["function_tolerance"])
        self.n_lm = int(d["n_landmarks"])
        self.window, self.families, self.losses = traffic.generate(
            d, self.B, seed, device)
        self.w0, self.fams = _build(win, fc, self.window, self.families)
        batched.assert_shared_topology(self.fams)
        self.opts = gn.SolverOptions(max_iterations=self.n_iter,
                                     function_tolerance=self.tol,
                                     scan_length=self.n_iter)
        self.items_per_solve = self.B
        # K1 solves the B reduced systems of the window's free dense dof
        # (15 per IMU state; the extrinsics are held) a step
        self.k1_shape = (self.B, 15 * int(d["n_kf"]))

    def warm_up(self) -> None:
        """One LM step of the timed call: every step has the same shapes."""
        self.solve(self.opts._replace(max_iterations=1, scan_length=1))

    def solve(self, opts=None):
        w, diag = self.batched.solve_batched_shared(
            self.w0, self.fams, self.losses, opts or self.opts)
        return dict(q=w.imu.q, p=w.imu.p, v=w.imu.v, bg=w.imu.bg,
                    ba=w.imu.ba, pt=w.landmarks.pt, cost=diag.final_cost)

    @staticmethod
    def count_failed(answers: List[Dict]) -> int:
        """Windows, over all answers, with a non-finite state or cost."""
        bad = 0
        for a in answers:
            ok = torch.isfinite(a["cost"])
            for k in ("q", "p", "v", "bg", "ba", "pt"):
                ok = ok & torch.isfinite(a[k]).flatten(1).all(dim=1)
            bad += int((~ok).sum())
        return bad

    def free_program(self) -> None:
        self.w0 = self.fams = None

    def reference(self, dtype=torch.float64) -> Dict[str, torch.Tensor]:
        """The reference's solve of every window, in blocks of
        ``REF_BLOCK`` windows so that it fits beside nothing else."""
        parts = []
        for b0 in range(0, self.B, REF_BLOCK):
            blk = lambda x: x[b0:b0 + REF_BLOCK]  # noqa: E731
            window = {k: {n: blk(x) for n, x in v.items()}
                      for k, v in self.window.items()}
            families = [(n, {k: blk(x) for k, x in v.items()})
                        for n, v in self.families]
            w, fams = _build(ref_window, ref_factors, window, families,
                             lambda x: x.to(dtype))
            w, _, cost = ref.solve(w, fams, self.losses, ref.Options(
                n_iter=self.n_iter, function_tolerance=self.tol))
            parts.append(dict(q=w.imu.q, p=w.imu.p, v=w.imu.v, bg=w.imu.bg,
                              ba=w.imu.ba, pt=w.landmarks.pt, cost=cost))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def compare(self, answers: List[Dict], want: Dict) -> Dict[str, float]:
        """The widest gaps of the answers from the reference's over every
        window: each state's rotation (rad), position (m), velocity (m/s),
        gyro bias (rad/s) and accelerometer bias (m/s²), each Euclidean
        landmark (m), each inverse depth (1/m), each window's final cost as
        each side reports it (relative), each window's excess cost (its cost
        at the answer's state over its cost at the reference's, less one)
        and each answer's own cost gap (its reported cost against the cost
        at its state, relative); and the batch's excess cost, the sum of
        every window's cost at the answer's state over the sum at the
        reference's, less one, the number a run compares. The reference
        works every cost out in float64."""
        n_lm = self.n_lm
        w = {k: v.double() for k, v in want.items()}
        best = self._cost64(w)
        gaps: Dict[str, float] = {}

        def put(name, value):
            value = value if math.isfinite(value) else math.inf
            gaps[name] = max(gaps.get(name, -math.inf), value)

        for a in answers:
            a = {k: v.double() for k, v in a.items()}
            dq = lie.quat_mul(lie.quat_conj(w["q"]), a["q"])
            put("rot_gap_rad", float(torch.linalg.vector_norm(
                lie.so3_log(dq), dim=-1).max()))
            for k, name in (("p", "pos_gap_m"), ("v", "vel_gap_mps"),
                            ("bg", "gyro_bias_gap"), ("ba", "accel_bias_gap")):
                put(name, float(torch.linalg.vector_norm(
                    a[k] - w[k], dim=-1).max()))
            put("landmark_gap_m", float(torch.linalg.vector_norm(
                a["pt"][:, :n_lm] - w["pt"][:, :n_lm], dim=-1).max()))
            put("inv_depth_gap", float(
                (a["pt"][:, n_lm:, 0] - w["pt"][:, n_lm:, 0]).abs().max()))
            put("cost_rel_gap", float(
                ((a["cost"] - w["cost"]).abs()
                 / w["cost"].abs().clamp(min=1e-30)).max()))
            here = self._cost64(a)
            put("excess_cost_rel", float(here.sum() / best.sum() - 1.0))
            put("window_excess_cost_rel", float((here / best - 1.0).max()))
            put("cost_self_gap", float(((a["cost"] - here).abs() / here).max()))
        return gaps

    def _cost64(self, state: Dict) -> torch.Tensor:
        """Every window's cost [B] at ``state``'s IMU states and landmarks,
        by the reference in float64."""
        window = dict(self.window)
        window["imu"] = dict(window["imu"], **{k: state[k] for k in
                                               ("q", "p", "v", "bg", "ba")})
        window["landmarks"] = dict(window["landmarks"], pt=state["pt"])
        w, fams = _build(ref_window, ref_factors, window, self.families,
                         lambda x: x.to(torch.float64))
        return ref.total_cost(w, fams, self.losses)

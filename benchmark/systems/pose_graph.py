"""The pose-graph system: the program's single-shard LM solve of a global
pose graph (``parallel.distributed_pgo.solve_single``), held to the plain
reference :mod:`benchmark.reference.pose_graph`.

One timed call is one whole solve of the graph from its initial guess:
``n_iter`` LM steps, each assembling the dense normal equations and
factoring them with K1. Every timed call starts from the same guess, so
every answer is compared with the one reference solve.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import lie
from benchmark.reference import pose_graph as ref
from benchmark.traffic import pose_graph as traffic


class System:
    """Set-up builds the graph from the seed and the program's inputs from
    it; :meth:`solve` enqueues one timed call and returns its answer."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
        self.dpgo = dpgo
        self.n_iter = int(mix["lm_steps"])
        self.prob = traffic.generate(config["deployment"], seed, device)
        p = self.prob
        self.state = dpgo.PGOState(q=p["q"], p=p["p"], free=p["free"])
        self.factors = dpgo.PGOFactors(
            i=p["i"], j=p["j"], dq=p["dq"], dp=p["dp"],
            sqrt_info=p["sqrt_info"], active=p["active"])
        self.priors = dpgo.PGOPriors(
            slot=p["prior_slot"], q0=p["prior_q0"], p0=p["prior_p0"],
            sqrt_info=p["prior_sqrt_info"], active=p["prior_active"])
        self.items_per_solve = 1
        # K1 solves one system of the graph's 6·N unknowns a step
        self.k1_shape = (1, 6 * p["q"].shape[0])

    def warm_up(self) -> None:
        """One LM step of the timed call: every step has the same shapes."""
        self.solve(n_iter=1)

    def solve(self, n_iter=None):
        out, _, cost = self.dpgo.solve_single(self.state, self.factors,
                                              self.priors,
                                              n_iter or self.n_iter)
        return dict(q=out.q, p=out.p, cost=cost)

    @staticmethod
    def count_failed(answers: List[Dict]) -> int:
        """Answers with a non-finite pose or cost."""
        return sum(not all(bool(torch.isfinite(a[k]).all())
                           for k in ("q", "p", "cost")) for a in answers)

    def free_program(self) -> None:
        """Drop the program's inputs; the plain tensors stay for the
        reference."""
        self.state = self.factors = self.priors = None

    def reference(self, dtype=torch.float64) -> Dict[str, torch.Tensor]:
        q, p, _, cost = ref.solve(self.prob, self.n_iter, dtype)
        return dict(q=q, p=p, cost=cost)

    def compare(self, answers: List[Dict], want: Dict) -> Dict[str, float]:
        """The widest gaps of the answers from the reference's: rotation
        (rad) and position (m) of any pose; the final cost's relative gap
        as each side reports it; the excess cost, the graph's cost at the
        answer's poses over its cost at the reference's, less one; and the
        answer's own cost gap, its reported cost against the cost at its
        poses. The reference works every cost out in float64."""
        gaps = dict(rot_gap_rad=0.0, pos_gap_m=0.0, cost_rel_gap=0.0,
                    excess_cost_rel=-math.inf, cost_self_gap=0.0)
        qr, pr = want["q"].double(), want["p"].double()
        cr = float(want["cost"])
        prob = {k: (v.double() if v.is_floating_point() else v)
                for k, v in self.prob.items()}
        c_best = float(ref.cost(prob, qr, pr))
        for a in answers:
            q, p = a["q"].double(), a["p"].double()
            c_here = float(ref.cost(prob, q, p))
            dq = lie.quat_mul(lie.quat_conj(qr), q)
            vals = dict(
                rot_gap_rad=float(torch.linalg.vector_norm(
                    lie.so3_log(dq), dim=-1).max()),
                pos_gap_m=float(torch.linalg.vector_norm(p - pr, dim=-1)
                                .max()),
                cost_rel_gap=abs(float(a["cost"]) - cr) / max(abs(cr), 1e-30),
                excess_cost_rel=c_here / c_best - 1.0,
                cost_self_gap=abs(float(a["cost"]) - c_here) / c_here)
            for k, v in vals.items():
                gaps[k] = max(gaps[k], v if math.isfinite(v) else math.inf)
        return gaps

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (beam_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds kernel K1 (the batched Cholesky factor+solve, csrc/cholesky.cu) with
nvcc for sm_90a, holds it against its plain PyTorch version on the card,
then drives the port's main path at the flagship LVIO census — one
Levenberg–Marquardt bundle-adjustment solve of a 40-state window (39 IMU,
39 lidar relative-pose, 2048 reprojection and 448 inverse-depth factors,
320 Schur-eliminated landmarks; a 640×640 reduced system) and the
shared-topology batched solve of 8 such windows — and checks the results.

Phases print one line each; any failure raises and exits non-zero. The
second-to-last line is the kernels' JSON record, the line before it the
card's name and power limit, and the last line the run's JSON verdict.
Requires CUDA: without a card it fails and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

LOSSES = (None, None, 1.0, 2.0, 2.0)
CENSUS = dict(n_kf=40, kf_dt=0.25, with_vision=True, n_landmarks=256,
              obs_per_lm=8, n_idp=64)
BATCH = 8
# K1 vs plain: the bound the reference's own kernel test uses
# (tests/test_pallas_cholesky.py), and a residual bound.
X_TOL, RES_TOL = 2e-3, 1e-2
# Flagship solve, card vs CPU plain path: same math, float32 sums in another
# order and atomics in the scatter assembly. Final cost relative gap, and the
# largest gap of any state position in metres (the CPU parity test's bound).
COST_RTOL, DP_TOL = 1e-5, 5e-4


def _spd(gen, B, N, cond=1e3):
    A = torch.randn(B, N, N, generator=gen)
    H = A @ A.transpose(1, 2) / N + torch.eye(N) / cond
    return H.cuda().contiguous(), torch.randn(B, N, generator=gen).cuda()


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _paired_ms(kernel, plain, reps=20):
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    p1 = _event_ms(plain, reps)
    k1 = _event_ms(kernel, reps)
    k2 = _event_ms(kernel, reps)
    p2 = _event_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _wall_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main() -> int:
    # ---- 1. require CUDA
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}", flush=True)

    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import nvcc_build
    from beam_slam_tpu_torch.solver import batched as bs
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.utils import synthetic

    # ---- 2. build K1 from csrc/
    path, ptxas, secs = nvcc_build.build("bst_cholesky", chol.SOURCES)
    chol.load_library()
    regs = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln]
    print(f"[2] built {path.name} in {secs:.2f} s; ptxas: {regs}", flush=True)

    # ---- 3. K1 vs its plain version on the card
    kernel, plain = chol.cholesky_solve_batched, \
        chol.cholesky_solve_batched_reference
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for B, N in ((1, 640), (8, 640), (3, 128), (2, 200)):
        H, g = _spd(gen, B, N)
        x, info = kernel(H, g)
        x_ref, info_ref = plain(H, g)
        torch.cuda.synchronize()
        err = float((x - x_ref).abs().max())
        scale = float(x_ref.abs().max())
        res = float((torch.einsum("bij,bj->bi", H, x) - g).abs().max())
        ok = (err <= X_TOL * scale and res <= RES_TOL * float(g.abs().max())
              and int(info.abs().sum()) == 0 and int(info_ref.abs().sum()) == 0)
        print(f"[3] K1 B={B} N={N}: max|x-x_ref|={err:.3e} "
              f"(bound {X_TOL * scale:.3e}), |Hx-g|inf={res:.3e}", flush=True)
        if not ok:
            raise RuntimeError(f"K1 disagrees with the plain version at "
                               f"B={B} N={N}")
        max_err = max(max_err, err)
    H, g = _spd(gen, 2, 128)
    H[1, 7, 7] = -1.0
    x, info = kernel(H, g)
    torch.cuda.synchronize()
    if not (int(info[1]) > 0 and bool(torch.isnan(x[1]).all())
            and int(info[0]) == 0 and bool(torch.isfinite(x[0]).all())):
        raise RuntimeError(f"indefinite system: info={info.tolist()}")
    print(f"[3] indefinite system: info={info.tolist()}, x NaN", flush=True)
    times = {}
    for B in (1, BATCH):
        H, g = _spd(gen, B, 640)
        times[B] = _paired_ms(lambda: kernel(H, g), lambda: plain(H, g))
        print(f"[3] K1 B={B} N=640: kernel {times[B][0]:.3f} ms, "
              f"plain {times[B][1]:.3f} ms (CUDA events, {card})", flush=True)

    # ---- 4. flagship solve on the card
    t0 = time.perf_counter()
    window, fams, losses = synthetic.build_lvio_window(
        torch.Generator().manual_seed(0), device="cuda", **CENSUS)
    torch.cuda.synchronize()
    if losses != LOSSES:
        raise RuntimeError(f"unexpected losses {losses}")
    print(f"[4] flagship window built on the card in "
          f"{time.perf_counter() - t0:.2f} s: {window.num_dense_dof} dense "
          f"dof, {window.landmarks.capacity} landmarks, factors "
          f"{[int(f.active.sum()) for f in fams]}", flush=True)
    options = gn.SolverOptions(max_iterations=10)

    # K1 on the main path's own reduced system (first LM step)
    H0, g0, H_ll0, g_l0, W0, _ = gn.assemble_normal_equations(window, fams,
                                                               LOSSES)
    free = torch.cat([window.dense_free_mask(),
                      torch.zeros(1, dtype=torch.bool, device="cuda")])
    lm_free = window.landmarks.active & ~window.landmarks.held
    Hp, gp, _ = gn._damped_reduced_system(
        H0, g0, free, torch.tensor(options.initial_lambda, device="cuda"),
        H_ll0, g_l0, W0, lm_free)
    x, _ = kernel(Hp[None].contiguous(), gp[None].contiguous())
    x_ref, _ = plain(Hp[None].contiguous(), gp[None].contiguous())
    torch.cuda.synchronize()
    sys_err = float((x - x_ref).abs().max())
    if Hp.shape != (640, 640) or not sys_err <= X_TOL * float(
            x_ref.abs().max()):
        raise RuntimeError(f"K1 on the flagship reduced system {Hp.shape}: "
                           f"err {sys_err}")
    print(f"[4] K1 on the flagship reduced system {tuple(Hp.shape)}: "
          f"max|x-x_ref|={sys_err:.3e}", flush=True)

    chol.cholesky_solve_batched.launches = 0
    out, diag = gn.solve(window, fams, LOSSES, options)
    torch.cuda.synchronize()
    launches_flagship = chol.cholesky_solve_batched.launches
    c0, c1 = float(diag.initial_cost), float(diag.final_cost)
    it = int(diag.iterations)
    if not (torch.isfinite(diag.final_cost) and c1 < c0
            and launches_flagship >= max(it, 1)):
        raise RuntimeError(f"flagship solve: cost {c0} -> {c1}, {it} "
                           f"iterations, {launches_flagship} K1 launches")
    t0 = time.perf_counter()
    out_cpu, diag_cpu = gn.solve(window.to("cpu"),
                                 tuple(f.to("cpu") for f in fams), LOSSES,
                                 options)
    cpu_s = time.perf_counter() - t0
    c1_cpu = float(diag_cpu.final_cost)
    gap = abs(c1 - c1_cpu) / c1_cpu
    dp = float((out.imu.p.cpu() - out_cpu.imu.p).abs().max())
    print(f"[4] flagship solve: cost {c0:.6g} -> {c1:.6g} in {it} accepted "
          f"steps, {launches_flagship} K1 launches; CPU plain path "
          f"{c1_cpu:.6g} (rel gap {gap:.2e}, bound {COST_RTOL}; max|dp| "
          f"{dp:.2e} m, bound {DP_TOL}; {cpu_s:.1f} s on the host)",
          flush=True)
    if not (gap <= COST_RTOL and dp <= DP_TOL):
        raise RuntimeError(f"flagship solve on the card vs CPU: final cost "
                           f"{c1} vs {c1_cpu}, max|dp| {dp}")
    solve_ms = _wall_ms(lambda: gn.solve(window, fams, LOSSES, options), 5)
    print(f"[4] flagship solve: median {solve_ms:.2f} ms over 5 "
          f"({options.max_iterations} LM steps, {card})", flush=True)

    # ---- 5. shared-topology batched solve on the card
    wins, fams_b, losses_b = synthetic.build_lvio_batch(
        torch.Generator().manual_seed(1), BATCH, device="cuda", **CENSUS)
    bs.assert_shared_topology(fams_b)
    chol.cholesky_solve_batched.launches = 0
    out_b, diag_b = bs.solve_batched_shared(wins, fams_b, losses_b, options)
    torch.cuda.synchronize()
    launches_batched = chol.cholesky_solve_batched.launches
    if not (bool(torch.isfinite(diag_b.final_cost).all())
            and bool((diag_b.final_cost < diag_b.initial_cost).all())
            and launches_batched >= 1):
        raise RuntimeError(f"batched solve: {diag_b.initial_cost.tolist()} -> "
                           f"{diag_b.final_cost.tolist()}, "
                           f"{launches_batched} K1 launches")
    batch_ms = _wall_ms(
        lambda: bs.solve_batched_shared(wins, fams_b, losses_b, options), 3)
    print(f"[5] batched B={BATCH}: every window's cost drops "
          f"(max final/initial "
          f"{float((diag_b.final_cost / diag_b.initial_cost).max()):.2e}), "
          f"{launches_batched} K1 launches; median {batch_ms:.2f} ms over 3 "
          f"({BATCH / batch_ms * 1e3:.1f} windows/s, {card})", flush=True)

    # ---- 6. records
    print(json.dumps({"kernels": [{
        "name": "cholesky_solve_batched", "route": "cuda",
        "source": "beam_slam_tpu_torch/csrc/cholesky.cu",
        "replaces": "beam_slam_tpu/ops/pallas_cholesky.py:226",
        "launches": launches_flagship + launches_batched,
        "max_abs_err": max_err, "ms": times[1][0], "plain_ms": times[1][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each seed, in one process: the cell's inputs, one timed call of the
program as the window runs it, the plain reference in float64 and the
numbers the run compares (:meth:`System.compare`). For each control seed,
the control in the program's place: the same plain reference computed in
the nearest precision below the configuration's (float32 with TF32
allowed, where the configuration states float32 with TF32 off), compared
in the same way. Prints one JSON line per reading and writes them all to
``--out``. The limits in ``workloads/<cell>.json`` lie between the
program's largest reading and the control's smallest.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_answer(system):
    """The plain reference in float32 with TF32 products: the control."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        return system.reference(dtype=torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def readings(root: Path, workload: str, seeds, control_seeds, device="cuda",
             log=sys.stderr):
    """One dict per reading: kind ("program" or "control"), seed, the
    compared numbers, and the seconds each part took."""
    import torch
    from benchmark import harness
    bench = harness.Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mod = bench.system(config)
    dev = torch.device(device)
    out = []
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        t0 = time.perf_counter()
        system = mod.System(config, cell["traffic"], seed, dev)
        system.warm_up()
        harness._sync(dev)
        t1 = time.perf_counter()
        answer = system.solve() if kind == "program" else None
        harness._sync(dev)
        t2 = time.perf_counter()
        failed = system.count_failed([answer]) if answer is not None else 0
        system.free_program()
        want = system.reference()
        harness._sync(dev)
        t3 = time.perf_counter()
        if answer is None:
            answer = control_answer(system)
            harness._sync(dev)
        gaps = system.compare([answer], want)
        row = dict(kind=kind, seed=seed, failed=failed, gaps=gaps,
                   setup_s=t1 - t0, solve_s=t2 - t1, reference_s=t3 - t2,
                   control_s=time.perf_counter() - t3)
        print(json.dumps(row), flush=True)
        out.append(row)
        del system, answer, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    rows = readings(ROOT, args.workload, args.seeds, args.control_seeds)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

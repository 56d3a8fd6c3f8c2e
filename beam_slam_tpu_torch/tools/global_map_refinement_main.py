"""Offline global-map refinement CLI (port of
``tools/global_map_refinement_main.py``).

Re-implements the reference's gflags tool
(bs_tools/src/global_map_refinement_main.cpp:1-50+): load a saved GlobalMap
data directory (saved by either package) → run submap refinement /
alignment / pose-graph optimization / batch optimization → save the map and
``refinement_stats.json``. Runs on the card unless ``--device`` names
another; without a card and without ``--device cpu`` it fails.

Usage:
  python -m beam_slam_tpu_torch.tools.global_map_refinement_main \
      --globalmap_dir /path/to/saved/map --output_path /path/out \
      [--run_submap_refinement] [--run_submap_alignment] \
      [--run_posegraph_optimization] [--run_batch_optimization] \
      [--refinement_config global_map/global_map_refinement.json \
       --config_root configs] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--globalmap_dir", required=True,
                    help="directory saved by GlobalMap.save()")
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--run_submap_refinement", action="store_true")
    ap.add_argument("--run_submap_alignment", action="store_true")
    ap.add_argument("--run_posegraph_optimization", action="store_true")
    ap.add_argument("--run_batch_optimization", action="store_true")
    ap.add_argument("--refinement_config", default=None,
                    help="global_map_refinement.json (reference schema); "
                         "paths inside resolve against --config_root")
    ap.add_argument("--config_root", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the map and the solves "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    from beam_slam_tpu_torch.device import resolve
    from beam_slam_tpu_torch.global_mapping import refinement
    from beam_slam_tpu_torch.global_mapping.global_map import GlobalMap

    device = resolve(None if args.device == "cuda" else args.device)
    gm = GlobalMap.load(args.globalmap_dir, device=device)
    print(f"loaded {len(gm.submaps)} submaps from {args.globalmap_dir} "
          f"onto {device}")

    ref_params = refinement.RefinementParams()
    batch_params = refinement.BatchOptimizationParams()
    if args.refinement_config:
        ref_params = refinement.RefinementParams.from_json(
            args.refinement_config, args.config_root)
        batch_params = refinement.BatchOptimizationParams.from_json(
            args.refinement_config, args.config_root)

    run_all = not (args.run_submap_refinement or args.run_submap_alignment
                   or args.run_posegraph_optimization
                   or args.run_batch_optimization)
    stats = {}
    t0 = time.perf_counter()
    if run_all or args.run_submap_refinement:
        stats["refinement_cost"] = refinement.run_submap_refinement(
            gm, params=ref_params)
        print("submap refinement done:", stats["refinement_cost"])
    if run_all or args.run_submap_alignment:
        stats["submaps_aligned"] = refinement.run_submap_alignment(gm)
        print("submap alignment done:", stats["submaps_aligned"])
    if run_all or args.run_posegraph_optimization:
        stats["loop_closures"] = refinement.run_pose_graph_optimization(gm)
        print("pose graph optimization done:", stats["loop_closures"])
    if run_all or args.run_batch_optimization:
        stats["batch"] = refinement.run_batch_optimization(
            gm, params=batch_params)
        print("batch optimization done:", stats["batch"])
    stats["wall_s"] = time.perf_counter() - t0

    gm.save(args.output_path)
    with open(os.path.join(args.output_path, "refinement_stats.json"),
              "w") as f:
        json.dump(stats, f, indent=2)
    print(f"saved refined map to {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

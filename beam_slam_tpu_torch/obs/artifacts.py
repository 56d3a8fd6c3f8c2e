"""Artifact dumps: trajectories, point clouds, graph visualizations (port of
:mod:`beam_slam_tpu.obs.artifacts`).

Covers the reference's observability outputs (SURVEY.md §5): the optional
artifact dumps (init results, graph updates, marginalized scans,
registration results — lvio.yaml:83-87), GraphVisualization's point-cloud
renderings of poses/constraints (bs_models/src/graph_visualization.cpp +
lib/graph_visualization/helpers.cpp), and trajectory files for offline ATE
evaluation. Everything here is host numpy: the writers take arrays, the
smoother's state comes from its host mirrors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie


def write_trajectory_tum(path: str,
                         traj: List[Tuple[float, np.ndarray, np.ndarray]]):
    """TUM format: t px py pz qx qy qz qw (evo-compatible)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for t, q, p in traj:
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def read_trajectory_tum(path: str):
    out = []
    for row in np.atleast_2d(np.loadtxt(path)):
        t, px, py, pz, qx, qy, qz, qw = row[:8]
        out.append((float(t), np.asarray([qw, qx, qy, qz], np.float32),
                    np.asarray([px, py, pz], np.float32)))
    return out


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud (the reference dumps PCDs; PLY is the
    dependency-free equivalent)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, pt in enumerate(points):
            line = f"{pt[0]:.4f} {pt[1]:.4f} {pt[2]:.4f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")


def read_ply(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        header = True
        for line in f:
            if header:
                if line.strip() == "end_header":
                    header = False
                continue
            vals = line.split()
            pts.append([float(v) for v in vals[:3]])
    return np.asarray(pts, np.float32)


def pose_frustum_cloud(q: np.ndarray, p: np.ndarray, scale: float = 0.2,
                       n: int = 10) -> np.ndarray:
    """Pose rendered as 3 colored axis segments worth of points
    (ImuStateToCloudInWorld / pose-cloud helpers, bs_common visualization.h)."""
    ts = np.linspace(0, scale, n)
    pts = []
    R = lie.quat_to_matrix(np.asarray(q, np.float32))
    for axis in range(3):
        d = R[:, axis]
        pts.append(p[None, :] + ts[:, None] * d[None, :])
    return np.concatenate(pts)


def graph_to_clouds(smoother) -> dict:
    """GraphVisualization onGraphUpdate outputs (graph_visualization.cpp:
    69-115): pose cloud, relative-pose constraint segments, landmark cloud,
    per-axis bias traces."""
    poses = []
    for t in smoother.current_stamps():
        st = smoother.get_state(t)
        poses.append(pose_frustum_cloud(st["q"], st["p"]))
    pose_cloud = np.concatenate(poses) if poses else np.zeros((0, 3))

    segments = []
    a = smoother.arena_rel
    for i in a.active_indices():
        s_i, s_j = int(a.slots[i, 0]), int(a.slots[i, 1])
        if smoother.state_active[s_i] and smoother.state_active[s_j]:
            p0, p1 = smoother.p[s_i], smoother.p[s_j]
            ts = np.linspace(0, 1, 8)[:, None]
            segments.append(p0[None, :] * (1 - ts) + p1[None, :] * ts)
    constraint_cloud = (np.concatenate(segments) if segments
                        else np.zeros((0, 3)))

    lm_cloud = smoother.lm_pt[smoother.lm_active]

    biases = []
    for t in smoother.current_stamps():
        st = smoother.get_state(t)
        biases.append((t, st["bg"].copy(), st["ba"].copy()))
    return dict(poses=pose_cloud, constraints=constraint_cloud,
                landmarks=lm_cloud, biases=biases)


def save_graph_artifacts(smoother, directory: str):
    """Per-update artifact dump (lvio.yaml:83-87 output folders)."""
    os.makedirs(directory, exist_ok=True)
    clouds = graph_to_clouds(smoother)
    write_ply(os.path.join(directory, "graph_poses.ply"), clouds["poses"])
    write_ply(os.path.join(directory, "graph_constraints.ply"),
              clouds["constraints"])
    write_ply(os.path.join(directory, "graph_landmarks.ply"),
              clouds["landmarks"])
    traj = []
    for t in smoother.current_stamps():
        st = smoother.get_state(t)
        traj.append((t, st["q"], st["p"]))
    write_trajectory_tum(os.path.join(directory, "trajectory_tum.txt"), traj)

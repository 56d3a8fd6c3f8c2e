"""Carry windows, factor families, lidar state and smoother state across
from the JAX package.

The JAX package's ``WindowState``, factor families, ``FeatureCloud``,
``RingGrid``, ``RegistrationMap``, session events and ``FixedLagSmoother``
host state arrive as plain dicts of numpy arrays (and, for the smoother,
the python index maps and lists beside them), field name → value (a window
as a dict of such dicts, one per sub-state), and become the port's
counterparts on a given device. The caller does the flattening (``np.asarray`` of every field), so this module
imports no JAX. Arrays may carry leading batch dims. Bool arrays stay bool,
integer arrays (slots) become int64, float arrays keep their dtype.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Mapping

import numpy as np
import torch

from beam_slam_tpu_torch.core import factors as fc
from beam_slam_tpu_torch.core.window import (ImuStates, Landmarks,
                                             MotionStates, Poses, WindowState)
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud, RingGrid
from beam_slam_tpu_torch.lidar.registration_map import RegistrationMap
from beam_slam_tpu_torch.models.visual_feature_tracker import \
    CameraMeasurement
from beam_slam_tpu_torch.solver.smoother import (ARENA_FAMILIES,
                                                 FixedLagSmoother,
                                                 SmootherConfig)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)  # copies; keeps bool / float dtype


def _build(cls, fields: Mapping[str, np.ndarray], device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{n: _tensor(fields[n], device) for n in names})


def window_from_numpy(d: Mapping[str, Mapping[str, np.ndarray]],
                      device) -> WindowState:
    """{"imu": {...}, "extrinsics": {...}, "landmarks": {...},
    "motion": {...}} → WindowState on ``device``."""
    return WindowState(
        imu=_build(ImuStates, d["imu"], device),
        extrinsics=_build(Poses, d["extrinsics"], device),
        landmarks=_build(Landmarks, d["landmarks"], device),
        motion=_build(MotionStates, d["motion"], device),
    )


def family_from_numpy(name: str, fields: Mapping[str, np.ndarray],
                      device) -> fc.FactorBatch:
    """A factor family by its class name (e.g. "ReprojectionFactors") and
    its fields → the port's family on ``device``."""
    if name not in fc.FAMILIES:
        raise KeyError(f"factor family {name!r} is not ported")
    return _build(fc.FAMILIES[name], fields, device)


def feature_cloud_from_numpy(fields: Mapping[str, np.ndarray],
                             device) -> FeatureCloud:
    """The JAX package's FeatureCloud as a dict of numpy arrays (field name →
    array) → the port's FeatureCloud on ``device``."""
    return _build(FeatureCloud, fields, device)


def ring_grid_from_numpy(fields: Mapping[str, np.ndarray],
                         device) -> RingGrid:
    """{"xyz", "time", "valid"} → the port's RingGrid on ``device``."""
    return _build(RingGrid, fields, device)


def camera_measurement_from_numpy(fields: Mapping[str, object]
                                  ) -> CameraMeasurement:
    """{"stamp", "ids", "pixels", "pixels_undistorted"} (the JAX package's
    CameraMeasurement as numpy) → the port's CameraMeasurement, on the
    host as the port keeps it."""
    return CameraMeasurement(
        stamp=float(fields["stamp"]),
        ids=np.asarray(fields["ids"]).astype(np.int64),
        pixels=np.asarray(fields["pixels"], np.float32).copy(),
        pixels_undistorted=np.asarray(fields["pixels_undistorted"],
                                      np.float32).copy())


def session_events_from_numpy(events, device) -> list:
    """The JAX package's session events (``generate_session_events``: a
    time-sorted list of ("imu", t, w, a), ("scan", t, grid),
    ("cam", measurement), ("pose", t, q, p) and ("tick", t) tuples), each
    scan's grid given as a dict of numpy arrays (see
    :func:`ring_grid_from_numpy`) and each camera measurement as one (see
    :func:`camera_measurement_from_numpy`) → the port's events, the grids
    on ``device``."""
    out = []
    for ev in events:
        if ev[0] == "scan":
            out.append(("scan", ev[1], ring_grid_from_numpy(ev[2], device)))
        elif ev[0] in ("imu", "pose"):
            out.append((ev[0], ev[1], np.asarray(ev[2], np.float32),
                        np.asarray(ev[3], np.float32)))
        elif ev[0] == "cam":
            out.append(("cam", camera_measurement_from_numpy(ev[1])))
        elif ev[0] == "tick":
            out.append(ev)
        else:
            raise KeyError(f"session event {ev[0]!r} is not ported")
    return out


def registration_map_from_numpy(fields: Mapping[str, object],
                                device) -> RegistrationMap:
    """Carry a host RegistrationMap across: its settings (map_size,
    edge_cap, surf_cap, world_voxel, world_edge_cap, world_surf_cap), its
    numpy ring buffer (edges, edges_valid, surfs, surfs_valid, q, p, used,
    stamps) and its next slot (``next``) → the port's RegistrationMap, whose
    world frame is built on ``device``."""
    m = RegistrationMap(
        map_size=int(fields["map_size"]), edge_cap=int(fields["edge_cap"]),
        surf_cap=int(fields["surf_cap"]),
        world_voxel=float(fields["world_voxel"]),
        world_edge_cap=int(fields["world_edge_cap"]),
        world_surf_cap=int(fields["world_surf_cap"]), device=device)
    for name in ("edges", "edges_valid", "surfs", "surfs_valid", "q", "p",
                 "used", "stamps"):
        dst = getattr(m, name)
        src = np.asarray(fields[name])
        if src.shape != dst.shape:
            raise ValueError(f"RegistrationMap.{name}: shape {src.shape}, "
                             f"expected {dst.shape}")
        dst[...] = src
    m._next = int(fields["next"])
    return m


# The host state of a FixedLagSmoother that a copy carries: the state,
# extrinsic, motion and landmark mirrors, the index maps and free lists,
# the generations, the robustness counters and the pipeline clock.
SMOOTHER_FIELDS = (
    "q", "p", "v", "bg", "ba", "state_active", "state_held", "stamp_of_slot",
    "slot_of_stamp", "_state_free", "state_gen",
    "ext_q", "ext_p", "ext_active", "ext_held", "ext_slot_of_name",
    "_ext_next", "mot_w", "mot_a", "mot_active",
    "lm_pt", "lm_active", "lm_held", "lm_id_of_slot", "slot_of_lm_id",
    "_lm_free", "lm_gen", "_lm_seq", "_lm_next_seq",
    "counters", "_latest_stamp", "_last_marginalized_stamps",
    "_last_released_lm_ids", "last_solved_stamp")
# Per factor arena: its slots, activity, fields, insertion order and free
# list.
ARENA_FIELDS = ("slots", "active", "fields", "seq", "_free", "_next_seq",
                "evictions")
ARENAS = tuple(name for name, _ in ARENA_FAMILIES)


def smoother_from_numpy(config: SmootherConfig,
                        fields: Mapping[str, object],
                        device) -> FixedLagSmoother:
    """A port smoother of ``config`` on ``device`` holding a copy of a JAX
    smoother's host state: ``fields`` maps every name of
    :data:`SMOOTHER_FIELDS` to that attribute's value, and every arena name
    of :data:`ARENAS` to a dict of its :data:`ARENA_FIELDS`. The next
    ``run_once`` on either side starts from the same problem."""
    sm = FixedLagSmoother(config, device=device)
    for name in SMOOTHER_FIELDS:
        src = fields[name]
        dst = getattr(sm, name)
        if isinstance(dst, np.ndarray) and np.shape(src) != dst.shape:
            raise ValueError(f"FixedLagSmoother.{name}: shape "
                             f"{np.shape(src)}, expected {dst.shape}")
        setattr(sm, name, copy.deepcopy(src))
    for arena_name in ARENAS:
        arena, src = getattr(sm, arena_name), fields[arena_name]
        for name in ARENA_FIELDS:
            val = copy.deepcopy(src[name])
            if name == "fields":
                for k, a in val.items():
                    if a.shape != arena.fields[k].shape:
                        raise ValueError(f"{arena_name}.{k}: shape {a.shape},"
                                         f" expected {arena.fields[k].shape}")
            setattr(arena, name, val)
    return sm


def submap_from_numpy(fields: Mapping[str, object], device):
    """The JAX package's Submap as plain values → the port's Submap on
    ``device``. ``fields``: ``stamp``, ``q``, ``p``, ``q_initial``,
    ``p_initial``, ``updates``; ``lidar_keyframes``, a list of dicts of
    ``stamp``, ``q``, ``p`` and ``features`` (a FeatureCloud as numpy, see
    :func:`feature_cloud_from_numpy`); ``camera_keyframes``, a list of dicts
    of ``stamp``, ``q``, ``p``, ``ids``, ``pixels``; ``subframe_poses``
    (stamp → (q, p)); ``descriptor`` (or None); ``landmarks`` (id →
    position) and ``landmark_words`` (id → word)."""
    from beam_slam_tpu_torch.global_mapping.submap import (CameraKeyframe,
                                                           LidarKeyframe,
                                                           Submap)
    f32 = lambda a: np.asarray(a, np.float32).copy()  # noqa: E731
    sm = Submap(float(fields["stamp"]), f32(fields["q"]), f32(fields["p"]),
                device=device)
    sm.q_initial, sm.p_initial = f32(fields["q_initial"]), \
        f32(fields["p_initial"])
    sm.updates = int(fields["updates"])
    for kf in fields["lidar_keyframes"]:
        sm.lidar_keyframes.append(LidarKeyframe(
            float(kf["stamp"]), f32(kf["q"]), f32(kf["p"]),
            feature_cloud_from_numpy(kf["features"], sm.device)))
    for ck in fields["camera_keyframes"]:
        sm.camera_keyframes.append(CameraKeyframe(
            float(ck["stamp"]), f32(ck["q"]), f32(ck["p"]),
            np.asarray(ck["ids"]).copy(), f32(ck["pixels"])))
    sm.subframe_poses = {float(t): (f32(q), f32(p))
                         for t, (q, p) in fields["subframe_poses"].items()}
    if fields.get("descriptor") is not None:
        sm.descriptor = f32(fields["descriptor"])
    sm.landmarks = {int(i): f32(x) for i, x in fields["landmarks"].items()}
    sm.landmark_words = {int(i): int(w)
                         for i, w in fields["landmark_words"].items()}
    return sm


def global_map_from_numpy(fields: Mapping[str, object], device):
    """The JAX package's GlobalMap as plain values → the port's GlobalMap
    on ``device``, with the default candidate search and refinement of its
    params (as ``GlobalMap.load`` builds them). ``fields``: ``params`` (the
    GlobalMapParams fields) and ``submaps``, a list of
    :func:`submap_from_numpy` dicts."""
    from beam_slam_tpu_torch.global_mapping.global_map import (
        GlobalMap, GlobalMapParams)
    gm = GlobalMap(GlobalMapParams(**dict(fields["params"])), device=device)
    gm.submaps = [submap_from_numpy(s, gm.device) for s in fields["submaps"]]
    return gm


def pgo_state_from_numpy(fields: Mapping[str, np.ndarray], device):
    """{"q", "p", "free"} (the JAX package's PGOState) → the port's
    PGOState on ``device``."""
    from beam_slam_tpu_torch.parallel.distributed_pgo import PGOState
    return _build(PGOState, fields, device)


def pgo_factors_from_numpy(fields: Mapping[str, np.ndarray], device):
    """{"i", "j", "dq", "dp", "sqrt_info", "active"} (PGOFactors) → the
    port's PGOFactors on ``device`` (slot indices as int64)."""
    from beam_slam_tpu_torch.parallel.distributed_pgo import PGOFactors
    return _build(PGOFactors, fields, device)


def pgo_priors_from_numpy(fields: Mapping[str, np.ndarray], device):
    """{"slot", "q0", "p0", "sqrt_info", "active"} (PGOPriors) → the port's
    PGOPriors on ``device``."""
    from beam_slam_tpu_torch.parallel.distributed_pgo import PGOPriors
    return _build(PGOPriors, fields, device)


def idp_unary_from_numpy(fields: Mapping[str, np.ndarray], device):
    """The JAX package's InverseDepthUnaryReprojectionFactors as numpy →
    the port's family on ``device``."""
    return family_from_numpy("InverseDepthUnaryReprojectionFactors", fields,
                             device)


def vocabulary_from_numpy(vocab: np.ndarray, device) -> torch.Tensor:
    """A binary-word vocabulary ``[n_words, 8]`` uint32 (the JAX package's
    ``ImageDatabase.vocab``) → the port's int32 tensor of the same bits on
    ``device``."""
    from beam_slam_tpu_torch.vision.descriptors import words_from_numpy
    return words_from_numpy(vocab, device)

"""Visual odometry model: frame localization against the visual map,
keyframe selection, map extension with triangulated landmarks, reprojection
factors into the smoother (port of
:mod:`beam_slam_tpu.models.visual_odometry`).

Re-implements the reference ``VisualOdometry`` plugin
(bs_models/src/visual_odometry.cpp — processMeasurements :134,
LocalizeFrame :217 with validation + fallback, IsKeyframe :401
(parallax / %tracked / time), ExtendMap :303 + ProcessLandmarkEUC :790,
reset after 10 localization failures :287-295) and the graph-facing parts of
``vision::VisualMap`` (lib/vision/visual_map.cpp — landmark/constraint
bookkeeping lives in the smoother's landmark store here).

This module is host orchestration: the per-frame PnP refine and the
per-candidate triangulations and gates are host numpy
(:mod:`beam_slam_tpu_torch.vision.geometry_np`), as in the JAX package;
the landmarks and reprojection factors it sends are solved by the smoother
on its device. The pipeline configuration carries :class:`VOParams` for
every mode (``LocalMapperConfig.vo``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.models.visual_feature_tracker import \
    CameraMeasurement
from beam_slam_tpu_torch.solver.smoother import (FixedLagSmoother,
                                                 SmootherConfig, Transaction)
from beam_slam_tpu_torch.vision import geometry_np as gnp
from beam_slam_tpu_torch.vision.camera import PinholeRadtan
from beam_slam_tpu_torch.vision.validation import VOLocalizationValidation


@dataclasses.dataclass
class VOParams:
    """Mirrors bs_parameters/models/visual_odometry_params.h (information
    weights → covariances 1/w², keyframe gates, validation gates)."""

    keyframe_parallax_px: float = 20.0
    keyframe_max_dt: float = 1.0
    keyframe_tracks_drop: float = 0.7   # keyframe if tracked fraction below
    # landmark parameterization (visual_odometry.cpp ProcessLandmarkEUC
    # :790 vs ProcessLandmarkIDP :722): Euclidean point or inverse-depth
    landmark_type: str = "EUC"          # EUC | IDP
    # standalone-VO mode (visual_odometry.cpp:330-342 + CreateVisualOdometry
    # Factor :984): keep a private graph for the visual BA and send only a
    # relative-pose factor per keyframe to the main graph
    standalone: bool = False
    standalone_lag_s: float = 4.0
    standalone_iterations: int = 8      # the 0.05 s local BA budget analog
    standalone_rel_cov: float = 1e-4
    track_cap: int = 256                # fixed capacity for localization
    reprojection_info_weight: float = 1.0
    max_triangulation_reproj_px: float = 5.0
    min_triangulation_parallax_px: float = 10.0
    # VOLocalizationValidation gates (vo_localization_validation.h:32-45)
    max_localization_error_px: float = 5.0
    max_correction_trans_m: float = 0.5
    max_correction_rot_deg: float = 30.0
    max_failures_before_reset: int = 10

    @staticmethod
    def from_json(source) -> "VOParams":
        """Load a reference-style vo_params.json
        (beam_slam_launch/config/vo/vo_params.json key names)."""
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        p = VOParams()
        if source.get("use_idp"):
            p.landmark_type = "IDP"
        if "max_triangulation_reprojection" in source:
            p.max_triangulation_reproj_px = float(
                source["max_triangulation_reprojection"])
        if "keyframe_parallax" in source:
            p.keyframe_parallax_px = float(source["keyframe_parallax"])
        if "keyframe_max_duration" in source:
            p.keyframe_max_dt = float(source["keyframe_max_duration"])
        if source.get("standalone_vo"):
            p.standalone = True
        return p


class VisualOdometry:
    def __init__(self, smoother: FixedLagSmoother, camera: PinholeRadtan,
                 params: VOParams = VOParams(), sensor_name: str = "cam0",
                 trigger_cb: Optional[Callable[[float], None]] = None,
                 frame_initializer: Optional[Callable] = None,
                 chunk_cb: Optional[Callable] = None):
        """``frame_initializer(t) -> (q_wb, p_wb)`` provides the pose seed
        (IMU odometry through FrameInitializer in the reference);
        ``trigger_cb(t)`` fires the inertial-odometry trigger per keyframe;
        ``chunk_cb(SlamChunk)`` publishes expired keyframes (+ their camera
        measurement and landmark positions) to the global mapper
        (PublishSlamChunk, visual_odometry.cpp:1125)."""
        self.smoother = smoother
        self.camera = camera
        self.params = params
        self.sensor = sensor_name
        self.trigger_cb = trigger_cb
        self.frame_initializer = frame_initializer
        self.chunk_cb = chunk_cb
        # standalone mode: the visual BA runs in a private graph; only
        # relative-pose factors reach the main smoother
        if params.standalone:
            from beam_slam_tpu_torch.solver import gauss_newton as gn_mod
            e = smoother.ext_slot_of_name.get(sensor_name, 0)
            self.local_smoother = FixedLagSmoother(SmootherConfig(
                lag_duration=params.standalone_lag_s, max_states=32,
                max_landmarks=smoother.cfg.max_landmarks,
                max_reprojection_factors=smoother.cfg
                .max_reprojection_factors,
                max_idp_factors=smoother.cfg.max_idp_factors,
                solver=gn_mod.SolverOptions(
                    max_iterations=params.standalone_iterations)),
                device=smoother.device)
            self.local_smoother.register_extrinsic(
                sensor_name, smoother.ext_q[e], smoother.ext_p[e])
            self.graph = self.local_smoother
        else:
            self.local_smoother = None
            self.graph = smoother
        # track container: id → list of (stamp, uv_undistorted)
        self.tracks: Dict[int, List[Tuple[float, np.ndarray]]] = {}
        # IDP bookkeeping: lm_id → (anchor_stamp, bearing mx,my)
        self.idp_anchor: Dict[int, Tuple[float, np.ndarray]] = {}
        self.keyframes: List[float] = []
        self.kf_meas: Dict[float, CameraMeasurement] = {}
        self.kf_pose: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}
        self.initialized = False
        self.failures = 0
        self.reset_count = 0
        self.odometry_log: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.validation = VOLocalizationValidation(
            t_init_thresh=params.max_correction_trans_m,
            r_init_thresh=np.deg2rad(params.max_correction_rot_deg))
        self._last_localize_ok = True
        # keep keyframe poses synced to the optimized graph so SlamChunks
        # and fallbacks carry post-optimization poses (reference
        # VisualOdometry::onGraphUpdate reads them live from the graph)
        smoother.register_on_update(self._on_graph_update)

    def _on_graph_update(self, smoother: FixedLagSmoother):
        for t in list(self.kf_pose.keys()):
            st = smoother.try_get_state(t)
            if st is not None:
                self.kf_pose[t] = (st["q"].copy(), st["p"].copy())

    # -- frames ------------------------------------------------------------
    def _camera_extrinsic(self):
        # host numpy: this runs several times per camera frame
        e = self.graph.ext_slot_of_name[self.sensor]
        return (np.asarray(self.graph.ext_q[e], np.float32),
                np.asarray(self.graph.ext_p[e], np.float32))

    def _camera_pose(self, q_wb, p_wb):
        q_bc, p_bc = self._camera_extrinsic()
        q_wb = np.asarray(q_wb, np.float32)
        p_wb = np.asarray(p_wb, np.float32)
        q_wc = np.asarray(lie.quat_mul(q_wb, q_bc))
        p_wc = p_wb + np.asarray(lie.quat_rotate(q_wb, p_bc))
        return q_wc, p_wc

    def _baselink_from_camera(self, q_wc, p_wc):
        q_bc, p_bc = self._camera_extrinsic()
        q_wc = np.asarray(q_wc, np.float32)
        p_wc = np.asarray(p_wc, np.float32)
        q_cb = np.asarray(lie.quat_conj(q_bc))
        p_cb = -np.asarray(lie.quat_rotate(q_cb, p_bc))
        q_wb = np.asarray(lie.quat_mul(q_wc, q_cb))
        p_wb = p_wc + np.asarray(lie.quat_rotate(q_wc, p_cb))
        return q_wb, p_wb

    def initialize(self, stamp: float):
        """Unblocked by the ignition graph update
        (visual_odometry.cpp:653)."""
        self.initialized = True

    def _landmark_world_point(self, lm_id: int):
        """World position of a landmark regardless of parameterization.
        IDP: anchor camera pose ∘ (bearing/ρ)."""
        val = self.graph.get_landmark(lm_id)
        if lm_id not in self.idp_anchor:
            return val  # Euclidean
        anchor_stamp, bearing = self.idp_anchor[lm_id]
        if anchor_stamp not in self.graph.slot_of_stamp:
            return None
        rho = max(float(val[0]), 1e-4)
        st = self.graph.get_state(anchor_stamp)
        q_wc, p_wc = self._camera_pose(st["q"], st["p"])
        X_a = np.array([bearing[0], bearing[1], 1.0], np.float32) / rho
        return np.asarray(lie.quat_rotate(np.asarray(q_wc), X_a)) + p_wc

    # -- localization ------------------------------------------------------
    def _localize(self, meas: CameraMeasurement, q_seed_wb, p_seed_wb):
        """LocalizeFrame (:217): 2d-3d pairs vs the visual map → batched PnP
        refine → validation; returns (q_wb, p_wb, ok)."""
        P = self.params
        cap = P.track_cap
        X = np.zeros((cap, 3), np.float32)
        uv = np.zeros((cap, 2), np.float32)
        valid = np.zeros(cap, bool)
        n = 0
        for i, lm_id in enumerate(meas.ids):
            if n >= cap:
                break
            if self.graph.has_landmark(int(lm_id)):
                pt = self._landmark_world_point(int(lm_id))
                if pt is None:
                    continue
                X[n] = pt
                uv[n] = meas.pixels_undistorted[i]
                valid[n] = True
                n += 1
        if n < 10:
            return np.asarray(q_seed_wb), np.asarray(p_seed_wb), False

        q_wc0, p_wc0 = self._camera_pose(q_seed_wb, p_seed_wb)
        # host-numpy PnP (geometry_np docstring): the per-frame refine is
        # microseconds on the host; geometry.refine_pose is the batch path.
        res = gnp.refine_pose_np(q_wc0, p_wc0, X, uv,
                                 np.asarray(self.camera.intr4), valid)
        if not res.converged \
                or res.mean_error_px > P.max_localization_error_px:
            return np.asarray(q_seed_wb), np.asarray(p_seed_wb), False
        # statistical validation on (correction, covariance-entropy,
        # reprojection) — VOLocalizationValidation (vo_localization_
        # validation.cpp Validate: rolling mean ± 2σ/5σ gates)
        dp = float(np.linalg.norm(res.p - p_wc0))
        dth = float(np.linalg.norm(np.asarray(lie.so3_log(np.asarray(
            lie.quat_mul(np.asarray(lie.quat_conj(res.q)), q_wc0))))))
        cov = np.linalg.inv(np.asarray(res.information, np.float64)
                            + 1e-9 * np.eye(6))
        if not self.validation.validate(dth, dp, cov,
                                        float(res.mean_error_px)):
            return np.asarray(q_seed_wb), np.asarray(p_seed_wb), False
        q_wb, p_wb = self._baselink_from_camera(res.q, res.p)
        return np.asarray(q_wb), np.asarray(p_wb), True

    # -- keyframe decision -------------------------------------------------
    def _is_keyframe(self, meas: CameraMeasurement) -> bool:
        """IsKeyframe (:401-452): first frame, time, tracked fraction, or
        median parallax vs the last keyframe."""
        P = self.params
        if not self.keyframes:
            return True
        t_kf = self.keyframes[-1]
        if meas.stamp - t_kf >= P.keyframe_max_dt:
            return True
        kf = self.kf_meas[t_kf]
        kf_ids = {int(i): k for k, i in enumerate(kf.ids)}
        shared = [(k, kf_ids[int(lm)]) for k, lm in enumerate(meas.ids)
                  if int(lm) in kf_ids]
        if not shared:
            return True
        if len(shared) / max(len(kf.ids), 1) < P.keyframe_tracks_drop:
            return True
        disp = [np.linalg.norm(meas.pixels_undistorted[a]
                               - kf.pixels_undistorted[b]) for a, b in shared]
        return float(np.median(disp)) > P.keyframe_parallax_px

    # -- map extension -----------------------------------------------------
    def _extend_map(self, meas: CameraMeasurement, txn: Transaction):
        """ExtendMap (:303-346): triangulate mature tracks into new
        landmarks, add reprojection factors for all keyframe observations of
        new landmarks plus the current observation of existing ones."""
        P = self.params
        w = P.reprojection_info_weight
        sqrt_info = (w * np.eye(2)).astype(np.float32)
        intr = np.asarray(self.camera.intr4, np.float32)

        idp = self.params.landmark_type == "IDP"
        for i, lm_id in enumerate(meas.ids):
            lm_id = int(lm_id)
            uv = meas.pixels_undistorted[i]
            if self.graph.has_landmark(lm_id):
                if idp and lm_id in self.idp_anchor:
                    anchor_stamp, bearing = self.idp_anchor[lm_id]
                    if anchor_stamp in self.graph.slot_of_stamp:
                        txn.add_idp_reprojection(
                            anchor_stamp, meas.stamp, lm_id, bearing, uv,
                            intr, sqrt_info, sensor=self.sensor)
                else:
                    txn.add_reprojection(meas.stamp, lm_id, uv, intr,
                                         sqrt_info, sensor=self.sensor)
                continue
            # candidate new landmark: need an old-enough keyframe observation
            # still inside the optimization window (constraints must only
            # reference live states — expired keyframes were marginalized)
            track = self.tracks.get(lm_id, [])
            kf_obs = [(t, px) for t, px in track
                      if t in self.kf_pose
                      and t in self.graph.slot_of_stamp]
            if not kf_obs:
                continue
            t0, uv0 = kf_obs[0]
            if np.linalg.norm(uv - uv0) < P.min_triangulation_parallax_px:
                continue
            # triangulate against the CURRENT optimized pose of the anchor
            # keyframe, not the pose recorded at keyframe creation: stale
            # anchor poses triangulate landmarks in an outdated frame, and
            # their reprojection factors then drag the whole graph back
            # toward that frame — a steady drift (~4 mm/s measured on the
            # 60 s LVIO session). The reference reads anchor poses from the
            # live graph via VisualMap::GetBaselinkPose
            # (bs_models/src/lib/vision/visual_map.cpp).
            st0 = self.graph.get_state(t0)
            q0_wb, p0_wb = st0["q"], st0["p"]
            q0_wc, p0_wc = self._camera_pose(q0_wb, p0_wb)
            q1_wc, p1_wc = self._camera_pose(*self._current_pose)
            # host-numpy triangulation + gates (geometry_np docstring): a
            # device version would wait for the device once per candidate
            fx, fy, cx, cy = [float(x) for x in np.asarray(intr)]
            ray0 = np.asarray([(float(uv0[0]) - cx) / fx,
                               (float(uv0[1]) - cy) / fy, 1.0])
            ray1 = np.asarray([(float(uv[0]) - cx) / fx,
                               (float(uv[1]) - cy) / fy, 1.0])
            X, ok = gnp.triangulate_dlt_np(q0_wc, p0_wc, q1_wc, p1_wc,
                                           ray0 / np.linalg.norm(ray0),
                                           ray1 / np.linalg.norm(ray1))
            if not ok:
                continue
            if not (gnp.reproj_gate_np(q1_wc, p1_wc, intr, X, uv,
                                       P.max_triangulation_reproj_px)
                    and gnp.reproj_gate_np(q0_wc, p0_wc, intr, X, uv0,
                                           P.max_triangulation_reproj_px)):
                continue
            if idp:
                # anchor at the first keyframe observation; ρ from the
                # triangulated depth in the anchor camera frame
                # (ProcessLandmarkIDP, visual_odometry.cpp:722-788)
                X_a = np.asarray(lie.quat_rotate(
                    np.asarray(lie.quat_conj(np.asarray(q0_wc))),
                    np.asarray(X) - np.asarray(p0_wc)))
                depth = float(X_a[2])
                if depth < 0.1:
                    continue
                bearing = np.asarray([(uv0[0] - cx) / fx, (uv0[1] - cy) / fy],
                                     np.float32)
                self.idp_anchor[lm_id] = (t0, bearing)
                txn.add_idp_landmark(lm_id, 1.0 / depth)
                for t_obs, uv_obs in kf_obs:
                    if t_obs == t0:
                        continue  # self-anchored observation: no information
                    txn.add_idp_reprojection(t0, t_obs, lm_id, bearing,
                                             uv_obs, intr, sqrt_info,
                                             sensor=self.sensor)
                txn.add_idp_reprojection(t0, meas.stamp, lm_id, bearing, uv,
                                         intr, sqrt_info, sensor=self.sensor)
            else:
                txn.add_landmark(lm_id, np.asarray(X))
                # observations from every keyframe that saw it + current frame
                for t_obs, uv_obs in kf_obs:
                    txn.add_reprojection(t_obs, lm_id, uv_obs, intr,
                                         sqrt_info, sensor=self.sensor)
                txn.add_reprojection(meas.stamp, lm_id, uv, intr, sqrt_info,
                                     sensor=self.sensor)

    # -- main entry --------------------------------------------------------
    def process_measurements(self, meas: CameraMeasurement) -> bool:
        """processMeasurements (:134-169). Returns True if a keyframe was
        created (and a transaction sent)."""
        P = self.params
        for i, lm_id in enumerate(meas.ids):
            self.tracks.setdefault(int(lm_id), []).append(
                (meas.stamp, meas.pixels_undistorted[i].copy()))
        # prune dead tracks occasionally
        if len(self.tracks) > 4096:
            live = set(int(i) for i in meas.ids)
            self.tracks = {k: v for k, v in self.tracks.items()
                           if k in live or self.graph.has_landmark(k)}
        if not self.initialized:
            return False

        if self.frame_initializer is not None:
            q_seed, p_seed = self.frame_initializer(meas.stamp)
        elif self.odometry_log:
            _, q_seed, p_seed = self.odometry_log[-1]
        else:
            q_seed, p_seed = np.array([1, 0, 0, 0], np.float32), np.zeros(3)

        q_wb, p_wb, ok = self._localize(meas, q_seed, p_seed)
        self._last_localize_ok = ok
        if not ok:
            # graceful fallback: keep the frame-initializer seed; any factor
            # built from this pose carries an inflated covariance
            # (visual_odometry.cpp:267-284)
            self.failures += 1
            if self.failures >= P.max_failures_before_reset:
                self.reset_count += 1
                self.failures = 0
                self.validation.clear()
        else:
            self.failures = 0
        self._current_pose = (q_wb, p_wb)
        self.odometry_log.append((meas.stamp, q_wb, p_wb))

        if not self._is_keyframe(meas):
            return False

        # keyframe: state + factors + triggers
        txn = Transaction(stamp=meas.stamp)
        if meas.stamp not in self.graph.slot_of_stamp:
            txn.add_imu_state(meas.stamp, q_wb, p_wb, np.zeros(3))
        self.kf_pose[meas.stamp] = (q_wb, p_wb)
        self._extend_map(meas, txn)
        prev_kf = self.keyframes[-1] if self.keyframes else None
        self.keyframes.append(meas.stamp)
        self.kf_meas[meas.stamp] = meas
        if self.local_smoother is not None:
            # standalone mode: full visual BA in the private graph, only a
            # relative VO factor to the main graph
            # (visual_odometry.cpp:330-342, CreateVisualOdometryFactor :984)
            if not self.local_smoother.slot_of_stamp:
                # gauge for the private graph: prior on its first keyframe
                txn.add_abs_pose(meas.stamp, q_wb, p_wb,
                                 1e2 * np.eye(6, dtype=np.float32))
            self.local_smoother.send_transaction(txn)
            self.local_smoother.run_once()
            if (prev_kf is not None
                    and prev_kf in self.local_smoother.slot_of_stamp
                    and meas.stamp in self.local_smoother.slot_of_stamp):
                a = self.local_smoother.get_state(prev_kf)
                b = self.local_smoother.get_state(meas.stamp)
                q_ai = np.asarray(lie.quat_conj(np.asarray(a["q"])))
                dq = np.asarray(lie.quat_mul(q_ai, np.asarray(b["q"])))
                dp = np.asarray(lie.quat_rotate(q_ai,
                                                np.asarray(b["p"] - a["p"])))
                # inflate covariance 100x when this keyframe's localization
                # fell back to the seed (visual_odometry.cpp:267-284)
                cov = self.params.standalone_rel_cov
                if not self._last_localize_ok:
                    cov *= 100.0
                w = 1.0 / np.sqrt(cov)
                main_txn = Transaction(stamp=meas.stamp)
                if prev_kf not in self.smoother.slot_of_stamp:
                    main_txn.add_imu_state(prev_kf, a["q"], a["p"],
                                           np.zeros(3))
                if meas.stamp not in self.smoother.slot_of_stamp:
                    main_txn.add_imu_state(meas.stamp, b["q"], b["p"],
                                           np.zeros(3))
                main_txn.add_relative_pose(
                    prev_kf, meas.stamp, np.asarray(dq), np.asarray(dp),
                    w * np.eye(6, dtype=np.float32))
                self.smoother.send_transaction(main_txn)
        else:
            self.smoother.send_transaction(txn)
        if self.trigger_cb is not None:
            self.trigger_cb(meas.stamp)
        # bound host-side keyframe history to the smoother lag; expired
        # keyframes are published as SlamChunks for the global mapper
        horizon = meas.stamp - self.graph.cfg.lag_duration
        while self.keyframes and self.keyframes[0] < horizon:
            t0 = self.keyframes.pop(0)
            kf_meas = self.kf_meas.pop(t0, None)
            kf_pose = self.kf_pose.pop(t0, None)
            if self.chunk_cb is not None and kf_pose is not None:
                from beam_slam_tpu_torch.models.lidar_odometry import \
                    SlamChunk
                lms = []
                if kf_meas is not None:
                    for lm_id in kf_meas.ids:
                        lm_id = int(lm_id)
                        if self.graph.has_landmark(lm_id):
                            X = self._landmark_world_point(lm_id)
                            if X is not None:
                                lms.append((lm_id, np.asarray(X,
                                                              np.float32)))
                self.chunk_cb(SlamChunk(
                    stamp=t0, q_wb=kf_pose[0], p_wb=kf_pose[1],
                    camera_measurement=kf_meas, landmarks=tuple(lms)))
        return True

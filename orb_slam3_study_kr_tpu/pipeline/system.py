"""Public session API (reference include/System.h): constructs the map +
pipeline stages, routes frames, manages the Atlas lifecycle (vocabulary
bootstrap, loop closing, relocalization, new-map spawning on sustained
tracking loss), and saves/loads sessions + trajectories.
"""

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_study_kr_tpu.pipeline.local_mapping import LocalMapper
from orb_slam3_study_kr_tpu.pipeline.tracking import (MonoTracker, TrackerConfig,
                                                      TrackState)
from orb_slam3_study_kr_tpu.slam_map.map_state import NO_LM, Atlas


@dataclass
class SystemConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    # "mono" | "stereo" | "rgbd" | "mono-inertial" | "stereo-inertial"
    # | "rgbd-inertial" (System.h eSensor incl. IMU_RGBD=5)
    sensor: str = "mono"
    baseline: float = 0.11   # stereo baseline [m] (Camera.bf / fx)
    # Fisheye (KB8) stereo rigs are non-rectified: the full extrinsic
    # p_right = R_rl p_left + t_rl replaces the baseline (reference Tlr,
    # Settings::readCamera2), and the right lens may differ from the left.
    stereo_R_rl: tuple = None    # 3x3; None = identity
    stereo_t_rl: tuple = None    # 3;   None = (-baseline, 0, 0)
    tracker_right: TrackerConfig = None  # None = same as left
    depth_factor: float = 40.0  # close-point threshold = factor * baseline
    # --- IMU (inertial sensors only; reference Settings IMU.* keys) ---
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3e-3
    imu_freq: float = 200.0
    imu_R_bc: tuple = None   # 3x3 body<-camera rotation (None = identity)
    imu_t_bc: tuple = None
    imu_init_times: tuple = (2.0, 5.0, 15.0)  # t1/t2/t3 stage schedule
    max_kf: int = 300
    max_lm: int = 80000
    enable_loop_closing: bool = True
    # Sustained loss: maps with fewer KFs than this are reset in place,
    # larger maps are stored and a fresh one spawned (Tracking.cc:2028-2046).
    min_kf_spawn: int = 10
    vocab_k: int = 8
    vocab_L: int = 3
    vocab_min_kfs: int = 5   # train the vocabulary once this many KFs exist
    # Pre-built vocabulary (System.cc:117 loadFromTextFile role): a DBoW2
    # text file (.txt, ORBvoc format) or a cached .npz from
    # bow.vocabulary.save_vocabulary.  None = train on this session's
    # descriptors once vocab_min_kfs keyframes exist.
    vocabulary_path: str = None
    # Distributed BA: shard global BA by landmark over this many devices
    # (0/1 = single device).  Uses jax.devices()[:ba_devices].
    ba_devices: int = 0
    # Background mapping/loop worker (the reference's LocalMapping +
    # LoopClosing threads, System.cc:195-214): keyframe mapping and the
    # loop cascade run on a worker thread so the frame path never blocks
    # on them.  Off = fully deterministic synchronous orchestration.
    async_mapping: bool = False
    async_max_pending: int = 3


class SlamSystem:
    """SLAM session (System::TrackMonocular/TrackStereo/TrackRGBD paths)."""

    def __init__(self, cfg: SystemConfig = None):
        self.cfg = cfg or SystemConfig()
        if (self.cfg.sensor in ("stereo", "rgbd", "stereo-inertial",
                                "rgbd-inertial")
                and self.cfg.tracker.bf == 0.0
                and self.cfg.tracker.camera_model != "kb8"):
            # Fisheye stereo keeps bf = 0: residuals stay per-camera KB8
            # projections, never the rectified u_r row.
            self.cfg.tracker.bf = self.cfg.tracker.fx * self.cfg.baseline
        self.atlas = Atlas()
        self.voc = None
        self.db = None
        self.loop_closer = None
        self.map_dbs = {}        # map_id -> KeyframeDatabase (stored maps)
        self.merger = None
        self.timings = []
        self.sys_stats = {}  # robustness-guard counters (resets, watchdogs)
        self._key = jax.random.PRNGKey(99)
        self.ba_mesh = None
        if self.cfg.ba_devices > 1:
            from orb_slam3_study_kr_tpu.parallel import make_ba_mesh
            devs = jax.devices()
            if len(devs) >= self.cfg.ba_devices:
                self.ba_mesh = make_ba_mesh(devs[: self.cfg.ba_devices])
        self.async_map = None
        if self.cfg.async_mapping:
            from orb_slam3_study_kr_tpu.pipeline.async_mapping import (
                AsyncMapping)
            self.async_map = AsyncMapping(
                max_pending=self.cfg.async_max_pending)
        self._new_active_map()

    # ------------------------------------------------------------------
    def _new_active_map(self):
        m = self.atlas.create_map(
            max_kf=self.cfg.max_kf,
            max_kp=self.cfg.tracker.orb_config.total_slots,
            max_lm=self.cfg.max_lm,
        )
        old_tracker = getattr(self, "tracker", None)
        self.local_mapper = LocalMapper(
            cfg=self.cfg.tracker, map=m,
            inertial_mode=self.cfg.sensor.endswith("-inertial"),
            on_kf_culled=self._on_kf_culled,
        )
        self.tracker = self._build_tracker(m)
        self.local_mapper.timers = self.tracker.timers
        self.tracker.async_map = self.async_map
        if self.cfg.sensor.endswith("-inertial"):
            # LocalInertialBA replaces visual local BA once the map is
            # IMU-initialized (LocalMapping.cc:154-160 dispatch).
            self.local_mapper.inertial_ba = self.tracker.local_inertial_ba
        if old_tracker is not None:
            # The session's relative-pose log spans map spawns (reference
            # mlRelativeFramePoses lives in Tracking, which is never
            # recreated); keep frame ids monotonic across maps too.
            self.tracker.trajectory = old_tracker.trajectory
            self.tracker.frame_count = old_tracker.frame_count
            self.tracker.only_tracking = old_tracker.only_tracking
        if self.db is not None:
            # Fresh map, fresh recognition index for it; the previous map's
            # index is retained so merge detection can hit its keyframes.
            from orb_slam3_study_kr_tpu.bow.database import KeyframeDatabase
            self.db = KeyframeDatabase(self.voc)
            self.map_dbs[m.map_id] = self.db
            from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser
            self.loop_closer = LoopCloser(cfg=self.cfg.tracker, map=m,
                                          db=self.db, ba_mesh=self.ba_mesh,
                                          inertial=self.cfg.sensor.endswith("-inertial"))

    def _build_tracker(self, m):
        kw = dict(
            local_mapper=self.local_mapper,
            loop_closer=self._on_keyframe_for_loops,
            relocalizer=self._relocalize,
            on_tracking_lost=self._on_tracking_lost,
        )
        if self.cfg.sensor == "mono":
            return MonoTracker(self.cfg.tracker, m, **kw)
        if self.cfg.sensor.endswith("-inertial"):
            from orb_slam3_study_kr_tpu.imu.preintegration import ImuCalib
            from orb_slam3_study_kr_tpu.pipeline.inertial_tracking import (
                InertialTracker, StereoInertialTracker)
            c = self.cfg
            calib = ImuCalib.make(
                noise_gyro=c.imu_noise_gyro, noise_acc=c.imu_noise_acc,
                walk_gyro=c.imu_walk_gyro, walk_acc=c.imu_walk_acc,
                freq=c.imu_freq, R_bc=c.imu_R_bc, t_bc=c.imu_t_bc)
            if self.cfg.sensor == "mono-inertial":
                return InertialTracker(
                    c.tracker, m, calib=calib,
                    imu_init_times=c.imu_init_times, **kw)
            if self.cfg.sensor == "rgbd-inertial":
                from orb_slam3_study_kr_tpu.pipeline.inertial_tracking import (
                    RgbdInertialTracker)
                return RgbdInertialTracker(
                    c.tracker, m, calib=calib,
                    imu_init_times=c.imu_init_times,
                    baseline=c.baseline, depth_factor=c.depth_factor, **kw)
            if c.tracker.camera_model == "kb8":
                from orb_slam3_study_kr_tpu.pipeline.inertial_tracking import (
                    FisheyeStereoInertialTracker)
                return FisheyeStereoInertialTracker(
                    c.tracker, m, calib=calib,
                    imu_init_times=c.imu_init_times,
                    R_rl=c.stereo_R_rl, t_rl=c.stereo_t_rl,
                    cfg_right=c.tracker_right,
                    depth_factor=c.depth_factor, **kw)
            return StereoInertialTracker(
                c.tracker, m, calib=calib, imu_init_times=c.imu_init_times,
                baseline=c.baseline, depth_factor=c.depth_factor, **kw)
        from orb_slam3_study_kr_tpu.pipeline.stereo_tracking import (
            FisheyeStereoTracker, StereoTracker)
        if (self.cfg.sensor == "stereo"
                and self.cfg.tracker.camera_model == "kb8"):
            return FisheyeStereoTracker(
                self.cfg.tracker, m, R_rl=self.cfg.stereo_R_rl,
                t_rl=self.cfg.stereo_t_rl, cfg_right=self.cfg.tracker_right,
                depth_factor=self.cfg.depth_factor, **kw)
        return StereoTracker(
            self.cfg.tracker, m, baseline=self.cfg.baseline,
            depth_factor=self.cfg.depth_factor, **kw)

    # ------------------------------------------------------------------
    def _ensure_vocabulary(self):
        if self.voc is not None or not self.cfg.enable_loop_closing:
            return
        m = self.atlas.active_map
        if self.cfg.vocabulary_path is None and m.n_kf < self.cfg.vocab_min_kfs:
            return
        from orb_slam3_study_kr_tpu.bow import KeyframeDatabase, train_vocabulary
        from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser
        kfs = np.nonzero(m.kf_valid)[0]
        if self.cfg.vocabulary_path is not None:
            # Pre-built vocabulary, shared across every map of the session.
            from orb_slam3_study_kr_tpu.bow.vocabulary import (load_dbow2_text,
                                                               load_vocabulary)
            p = str(self.cfg.vocabulary_path)
            self.voc = (load_dbow2_text(p) if p.endswith(".txt")
                        else load_vocabulary(p))
        else:
            descs = np.concatenate([
                m.kf_desc[k][m.kf_kp_valid[k]] for k in kfs
            ])
            self.voc = train_vocabulary(descs, k=self.cfg.vocab_k,
                                        L=self.cfg.vocab_L, seed=0)
        self.db = KeyframeDatabase(self.voc)
        self.map_dbs[m.map_id] = self.db
        self.loop_closer = LoopCloser(cfg=self.cfg.tracker, map=m,
                                      db=self.db, ba_mesh=self.ba_mesh,
                                          inertial=self.cfg.sensor.endswith("-inertial"))
        for k in kfs:
            self.db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])

    def _on_keyframe_for_loops(self, kf: int) -> bool:
        self._ensure_vocabulary()
        if self.loop_closer is None:
            return False
        hit = self.loop_closer.process_keyframe(kf)
        if not hit and len(self.atlas.maps) > 1:
            hit = self._try_merge(kf)
        return hit

    # ------------------------------------------------------------------
    def _try_merge(self, kf: int) -> bool:
        """Place-recognition against stored maps; weld on a verified hit
        (LoopClosing::MergeLocal / MergeLocal2 role)."""
        from orb_slam3_study_kr_tpu.pipeline.map_merging import MapMerger

        if self.merger is None:
            self.merger = MapMerger(cfg=self.cfg.tracker)
        mA = self.atlas.active_map
        fix_scale = (self.cfg.sensor != "mono")
        for bi, mB in enumerate(self.atlas.maps):
            if mB is mA:
                continue
            db = self.map_dbs.get(mB.map_id)
            if db is None or mB.n_kf == 0:
                continue
            cands = db.detect_relocalization_candidates(
                mA.kf_desc[kf], mA.kf_kp_valid[kf], n_best=3)
            for cand in cands:
                sim3 = self.merger.verify(mA, kf, mB, int(cand),
                                          fix_scale=fix_scale)
                if sim3 is None:
                    continue
                if self.async_map is not None:
                    # Verified on the worker; the structural transplant
                    # (map transfer + tracker rebinding) is deferred to
                    # the tracker thread at the next frame boundary.
                    self.async_map.post_event(
                        "merge", (mA, kf, mB, int(cand), sim3))
                    return True
                res = self.merger.merge(mA, kf, mB, int(cand), sim3)
                if res is None:
                    continue
                self._apply_merge(mA, bi, res)
                return True
        return False

    def _apply_merge(self, old_map, target_idx, res):
        """Transplant the session onto the merged map: rebind the pipeline
        stages, remap tracker state, rescale kinematics by sigma, rewrite
        trajectory rows, and run the welding local BA."""
        from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser

        mB = res.target_map
        tr = self.tracker
        # Atlas: drop the absorbed map, activate the target.
        self.atlas.maps.remove(old_map)
        self.atlas.active = self.atlas.maps.index(mB)
        self.map_dbs.pop(old_map.map_id, None)

        # Recognition index for the target map gains the transferred KFs.
        self.db = self.map_dbs.get(mB.map_id)
        if self.db is not None:
            for a, j in res.kf_map.items():
                self.db.add(int(j), mB.kf_desc[j], mB.kf_kp_valid[j])
            self.loop_closer = LoopCloser(cfg=self.cfg.tracker, map=mB,
                                          db=self.db, ba_mesh=self.ba_mesh,
                                          inertial=self.cfg.sensor.endswith("-inertial"))

        # Pipeline stages follow the new map.
        self.local_mapper.map = mB
        tr.map = mB

        def remap_lm(arr):
            ok = arr != NO_LM
            out = arr.copy()
            out[ok] = res.lm_map[np.clip(arr[ok], 0, old_map.max_lm - 1)]
            return out.astype(np.int32)

        for f in (tr.last_frame, getattr(tr, "init_ref", None)):
            if f is not None and f.kp_lm is not None:
                f.kp_lm = remap_lm(f.kp_lm)
                if f.R_cw is not None:
                    f.R_cw = f.R_cw @ res.R_BA.T
                    f.t_cw = (res.sigma * f.t_cw - f.R_cw @ res.t_BA).astype(
                        np.float32)
                f.ref_kf = res.kf_map.get(f.ref_kf, -1)
        tr.ref_kf = res.kf_map.get(tr.ref_kf, max(res.kf_map.values()))
        if tr.velocity is not None:
            Rv, tv = tr.velocity
            tr.velocity = (Rv, (res.sigma * tv).astype(np.float32))
        tr._speed_hist = [s * res.sigma for s in tr._speed_hist]

        # Trajectory rows of the absorbed map replay against the target map
        # under the merge transform (relative rotations are invariant;
        # relative translations scale by sigma).
        new_rows = []
        for (ts, ref, Rrel, trel, state, ok, m) in tr.trajectory:
            if m is old_map:
                # Culled references climb their redirect chain in the old
                # map first (kf_map only covers live keyframes).
                ref, Rrel, trel = old_map.resolve_kf(int(ref), Rrel, trel)
                if ref < 0:
                    continue
                new_rows.append((ts, res.kf_map.get(int(ref), 0), Rrel,
                                 (res.sigma * trel).astype(np.float32),
                                 state, ok, mB))
            else:
                new_rows.append((ts, ref, Rrel, trel, state, ok, m))
        tr.trajectory = new_rows

        # Two-map welding BA (MergeLocal's welding window,
        # LoopClosing.cc:1220-1785): the re-entry keyframe's neighborhood
        # (transferred map) + the matched keyframe's neighborhood (target
        # map) are optimized together, every far-side observer fixed.  For
        # an IMU-initialized merged map the VI temporal seam solve runs
        # first (MergeInertialBA role, Optimizer.cc:3956) and the welding
        # window then holds the target side rigid so the target's
        # gravity-consistent structure is preserved.
        WELD_WINDOW = 25            # LoopClosing.cc:1220 numTemporalKFs
        kf_new = tr.ref_kf
        nb_a, _ = mB.covisibility(kf_new, min_shared=1)
        window_a = np.concatenate([[kf_new], nb_a[: WELD_WINDOW - 1]])
        nb_b, _ = mB.covisibility(int(res.target_kf), min_shared=1)
        window_b = np.concatenate([[res.target_kf],
                                   nb_b[: WELD_WINDOW - 1]])
        inertial_weld = (self.cfg.sensor.endswith("-inertial")
                         and mB.imu_initialized
                         and hasattr(tr, "local_inertial_ba"))
        if inertial_weld:
            tr.local_inertial_ba(tr.ref_kf)
        self.local_mapper.welding_ba(window_a, window_b,
                                     fix_b=inertial_weld)

    # ------------------------------------------------------------------
    def _on_kf_culled(self, kf: int):
        """A keyframe was erased by LocalMapping: drop it from the
        recognition index and re-point the tracker if it was the reference
        (the reference's KeyFrameDatabase::erase + Tracking's bad-KF
        replacement in UpdateLocalKeyFrames)."""
        if self.db is not None:
            self.db.erase(kf)
        tr = self.tracker
        m = self.atlas.active_map
        if tr.ref_kf == kf:
            live, _, _ = m.resolve_kf(kf, np.eye(3, dtype=np.float32),
                                      np.zeros(3, np.float32))
            tr.ref_kf = live if live >= 0 else int(
                np.nonzero(m.kf_valid)[0][-1])

    # ------------------------------------------------------------------
    # Relocalization cascade acceptance (Tracking.cc:3775,3797,3819):
    RELOC_ACCEPT = 50        # nGood for acceptance
    RELOC_RETRY_MIN = 30     # narrow re-search only when 30 < nGood < 50

    def _relocalize(self, frame) -> bool:
        """BoW candidates + RANSAC PnP + the reference's widening
        refinement cascade (Tracking::Relocalization, Tracking.cc:
        3663-3830): PnP seeds a pose, PoseOptimization counts inliers;
        below 50 a guided SearchByProjection with a WIDE window
        (th=10, desc gate 100, :3781) adds matches and re-optimizes;
        if that lands in (30, 50) a NARROW pass (th=3, gate 64, :3797)
        runs once more.  The old single-shot path lost exactly the
        kidnap recoveries where PnP's descriptor-only match set is
        too thin."""
        if self.db is None:
            return False
        from orb_slam3_study_kr_tpu.ops.track_match import match_by_descriptor
        from orb_slam3_study_kr_tpu.solvers.pnp import ransac_pnp

        m = self.atlas.active_map
        cfg = self.cfg.tracker
        tr = self.tracker
        with m.lock:
            cands = self.db.detect_relocalization_candidates(
                frame.desc, frame.valid)
        self._reloc_best = 0
        for kf in cands:
            with m.lock:
                bound = m.kf_kp_lm[kf] != NO_LM
                idx, ok, _ = match_by_descriptor(
                    frame.dev("desc"), frame.dev("valid"),
                    jnp.asarray(m.kf_desc[kf]),
                    jnp.asarray(m.kf_kp_valid[kf] & bound),
                )
                idx = np.asarray(idx)
                ok = np.asarray(ok)
                if ok.sum() < 15:
                    continue
                lm = np.where(ok, m.kf_kp_lm[kf][idx], NO_LM)
                X = m.lm_pos[np.clip(lm, 0, m.max_lm - 1)]
                mask = (lm != NO_LM) & m.lm_valid[np.clip(lm, 0,
                                                          m.max_lm - 1)]
                kf_lms = m.kf_kp_lm[kf]
                kf_lms = np.unique(kf_lms[kf_lms != NO_LM])
                kf_lms = kf_lms[m.lm_valid[kf_lms]]
            self._key, sub = jax.random.split(self._key)
            bearings = None
            if cfg.camera_model == "kb8":
                bearings = cfg.unproject_fn(frame.dev("uv"))
            out = ransac_pnp(
                sub, cfg.project_fn, cfg.project_jac_fn, cfg.K,
                jnp.asarray(X), frame.dev("uv"),
                frame.dev("level"), jnp.asarray(mask.astype(np.float32)),
                bearings=bearings,
            )
            if not bool(out["success"]):
                continue
            frame.R_cw = np.asarray(out["R"])
            frame.t_cw = np.asarray(out["t"])
            inl = np.asarray(out["inliers"]) & mask
            frame.kp_lm = np.where(inl, lm, NO_LM).astype(np.int32)
            n_good = tr._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
            if n_good < self.RELOC_ACCEPT and kf_lms.size >= 3:
                # Wide guided re-search around the optimized pose.
                matched, _, _ = tr._match_against_landmarks(
                    frame, kf_lms, frame.R_cw, frame.t_cw, th=10.0,
                    wide_gates=True)
                free = frame.kp_lm == NO_LM
                frame.kp_lm = np.where(free, matched,
                                       frame.kp_lm).astype(np.int32)
                n_good = tr._optimize_frame_pose(frame, frame.R_cw,
                                                 frame.t_cw)
                if self.RELOC_RETRY_MIN < n_good < self.RELOC_ACCEPT:
                    # Narrow final pass with the twice-refined pose.
                    matched, _, _ = tr._match_against_landmarks(
                        frame, kf_lms, frame.R_cw, frame.t_cw, th=3.0,
                        wide_gates=True)
                    free = frame.kp_lm == NO_LM
                    frame.kp_lm = np.where(free, matched,
                                           frame.kp_lm).astype(np.int32)
                    n_good = tr._optimize_frame_pose(frame, frame.R_cw,
                                                     frame.t_cw)
            if n_good >= self.RELOC_ACCEPT:
                frame.pose_ok = True
                self.sys_stats["n_reloc"] = (
                    self.sys_stats.get("n_reloc", 0) + 1)
                return True
            # Accept a thinner PnP-only pose as a last resort only when
            # no candidate reaches the full acceptance bar — the
            # single-shot behavior, kept as fallback for sparse synthetic
            # scenes where 50 inliers cannot exist.
            if n_good >= 15 and getattr(self, "_reloc_best", 0) < n_good:
                self._reloc_best = n_good
                self._reloc_pose = (frame.R_cw.copy(), frame.t_cw.copy(),
                                    frame.kp_lm.copy())
        best = getattr(self, "_reloc_best", 0)
        if best >= 15:
            R, t, kp_lm = self._reloc_pose
            frame.R_cw, frame.t_cw, frame.kp_lm = R, t, kp_lm
            frame.pose_ok = True
            self._reloc_best = 0
            self.sys_stats["n_reloc_weak"] = (
                self.sys_stats.get("n_reloc_weak", 0) + 1)
            return True
        self._reloc_best = 0
        return False

    # ------------------------------------------------------------------
    def _on_tracking_lost(self):
        """Sustained loss: small maps reset in place, established maps are
        stored and a new one spawned (Tracking::CreateMapInAtlas)."""
        if self.async_map is not None:
            # The worker may still hold tasks against the outgoing map;
            # let it drain before the map is stored/discarded.
            self.async_map.flush()
        m = self.atlas.active_map
        if m.n_kf < self.cfg.min_kf_spawn:
            self.atlas.maps.remove(m)
            self.atlas.active = len(self.atlas.maps) - 1
            self.map_dbs.pop(m.map_id, None)
            # The discarded map's gauge is gone; its trajectory rows must
            # not replay (reference: frames whose reference KF belongs to a
            # destroyed map are skipped at save time).
            m.kf_valid[:] = False
        self._new_active_map()

    # ------------------------------------------------------------------
    MAX_TS_GAP = 1.0     # s: forward jump that invalidates tracking state
    BAD_IMU_KFS = 20     # keyframes without IMU init => bad-IMU reset

    def _check_timestamp(self, timestamp) -> None:
        """Timestamp-jump guard (Tracking.cc:1837-1865): a backward step or
        a forward gap > MAX_TS_GAP means the sensor stream broke (dataset
        change, dropped frames); the motion model and any in-flight IMU
        preintegration are meaningless across the gap, so the current map
        is stored and a fresh one spawned (CreateMapInAtlas)."""
        last = getattr(self, "_last_frame_ts", None)
        self._last_frame_ts = timestamp
        if last is None:
            return
        gap = timestamp - last
        if gap < 0 or gap > self.MAX_TS_GAP:
            tr = self.tracker
            if tr.state == TrackState.NOT_INITIALIZED:
                return  # nothing to protect yet
            self.sys_stats["n_ts_resets"] = (
                self.sys_stats.get("n_ts_resets", 0) + 1)
            if tr.only_tracking:
                # Localization-only mode freezes the map (the reference
                # never discards maps under mbOnlyTracking): drop the
                # motion/IMU transients and fall back to relocalization
                # against the existing map.
                tr.velocity = None
                tr.state = TrackState.RECENTLY_LOST
                tr.last_ok_ts = timestamp   # fresh grace period
                if hasattr(tr, "_pre_frame"):
                    tr._pre_frame = None
                    tr._imu_log = []
                return
            self._on_tracking_lost()

    def _check_bad_imu(self, frame) -> None:
        """Bad-IMU watchdog (LocalMapping.cc:139-148): a map that keeps
        failing IMU initialization long past the point it should have
        succeeded has an unobservable scale — reset it rather than let an
        unaligned, mis-scaled map grow."""
        if not self.cfg.sensor.endswith("-inertial"):
            return
        m = self.atlas.active_map
        tr = self.tracker
        if m.imu_initialized or tr.state != TrackState.OK:
            return
        first = getattr(tr, "_first_kf_ts", None)
        if first is None:
            return
        if m.n_kf >= self.BAD_IMU_KFS and frame.timestamp - first > 10.0:
            self.sys_stats["n_bad_imu_resets"] = (
                self.sys_stats.get("n_bad_imu_resets", 0) + 1)
            self._on_tracking_lost()

    def _drain_async_events(self):
        """Apply worker-posted effects on the tracker thread at a frame
        boundary: velocity reset after a loop correction, and deferred map
        merges (the reference's flag-handshake role)."""
        if self.async_map is None:
            return
        # A crashed worker task must not be silent until flush(): surface
        # it on the tracker thread within one frame (it was logged at
        # catch time; raising here stops tracking against a frozen map).
        errs = self.async_map.pop_errors()
        if errs:
            raise errs[0]
        for kind, payload in self.async_map.drain_events():
            if kind == "loop":
                # Poses moved under the corrected essential graph; the
                # stale velocity model would fight the corrected map.
                self.tracker.velocity = None
            elif kind == "merge":
                mA, kf, mB, cand, sim3 = payload
                if mA is not self.atlas.active_map or mB not in self.atlas.maps:
                    continue
                self.async_map.flush()
                with mA.lock, mB.lock:
                    # The Sim3 was estimated at detection time; local BA and
                    # new keyframes may have moved both maps since.  Re-run
                    # the verification at apply time so the weld uses a
                    # transform consistent with the CURRENT poses (a failed
                    # re-verify drops the merge rather than welding stale).
                    fresh = self.merger.verify(
                        mA, kf, mB, cand,
                        fix_scale=mA.imu_initialized and mB.imu_initialized)
                    if fresh is None:
                        self.sys_stats["n_stale_merges"] = (
                            self.sys_stats.get("n_stale_merges", 0) + 1)
                        continue
                    res = self.merger.merge(mA, kf, mB, cand, fresh)
                    if res is not None:
                        self._apply_merge(
                            mA, self.atlas.maps.index(mB), res)
                        self.tracker.velocity = None

    def upload_image(self, img):
        """Asynchronously upload a camera image and return its device
        handle, accepted by every track_* entry in place of the host
        array.  Call during IO/decode time of the NEXT frame: the H2D
        transfer then overlaps host work instead of serializing ahead
        of the frame's extraction program.  Images keep their native
        dtype (uint8 preferred — 4x less transfer than float32)."""
        if isinstance(img, jax.Array):
            return img
        img = np.asarray(img)
        return jnp.asarray(img if img.dtype == np.uint8
                           else img.astype(np.float32))

    def track_monocular(self, img, timestamp, imu=None):
        """System::TrackMonocular; with imu rows (M, 7) [dt, acc, gyro]
        covering (t_prev, t] this is the monocular-inertial path."""
        self._drain_async_events()
        self._check_timestamp(timestamp)
        t0 = time.perf_counter()
        if self.cfg.sensor == "mono-inertial":
            frame = self.tracker.process_inertial(
                img, timestamp,
                imu if imu is not None else np.zeros((0, 7), np.float32))
        else:
            frame = self.tracker.process(img, timestamp)
        self.timings.append(time.perf_counter() - t0)
        self._check_bad_imu(frame)
        return frame

    def track_stereo(self, img_left, img_right, timestamp, imu=None):
        """System::TrackStereo: rectified left/right pair (+ optional IMU)."""
        self._drain_async_events()
        self._check_timestamp(timestamp)
        t0 = time.perf_counter()
        if self.cfg.sensor == "stereo-inertial":
            frame = self.tracker.process_stereo_inertial(
                img_left, img_right, timestamp,
                imu if imu is not None else np.zeros((0, 7), np.float32))
        else:
            frame = self.tracker.process_stereo(img_left, img_right, timestamp)
        self.timings.append(time.perf_counter() - t0)
        self._check_bad_imu(frame)
        return frame

    def track_rgbd(self, img, depth_map, timestamp, imu=None):
        """System::TrackRGBD: image + registered metric depth map
        (+ optional IMU rows for the rgbd-inertial sensor)."""
        self._drain_async_events()
        self._check_timestamp(timestamp)
        t0 = time.perf_counter()
        if self.cfg.sensor == "rgbd-inertial":
            frame = self.tracker.process_rgbd_inertial(
                img, depth_map, timestamp,
                imu if imu is not None else np.zeros((0, 7), np.float32))
        else:
            frame = self.tracker.process_rgbd(img, depth_map, timestamp)
        self.timings.append(time.perf_counter() - t0)
        self._check_bad_imu(frame)
        return frame

    def flush(self):
        """Wait for the background mapper/loop worker to drain and apply
        its pending events (no-op in synchronous mode).  Call before
        reading final state (trajectories, stats, atlas save)."""
        if self.async_map is not None:
            self.async_map.flush()
            self._drain_async_events()
            self.async_map.flush()

    def shutdown(self):
        """System::Shutdown: stop the background worker."""
        if self.async_map is not None:
            self.flush()
            self.async_map.shutdown()

    def activate_localization_mode(self):
        """Track against the frozen map without mutating it
        (System::ActivateLocalizationMode, System.h:118)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode)."""
        self.tracker.only_tracking = False

    @property
    def state(self):
        return self.tracker.state

    def trajectory(self, with_map_ids=False):
        return self.tracker.final_trajectory(with_map_ids=with_map_ids)

    def save_trajectory_tum(self, path):
        """TUM format: ts tx ty tz qx qy qz qw (System::SaveTrajectoryTUM)."""
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                ts, x, y, z, qw, qx, qy, qz = r
                f.write(f"{ts:.6f} {x:.7f} {y:.7f} {z:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_euroc(self, path):
        """EuRoC format: ns-timestamp + pose (System::SaveTrajectoryEuRoC
        System.cc:662 — same fields as TUM, integer-nanosecond stamps)."""
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                ts, x, y, z, qw, qx, qy, qz = r
                f.write(f"{int(round(ts * 1e9))} {x:.7f} {y:.7f} {z:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_kitti(self, path):
        """KITTI format: per-frame 3x4 T_wc row-major, no timestamps
        (System::SaveTrajectoryKITTI)."""
        from orb_slam3_study_kr_tpu.lie.so3 import quat_to_matrix
        rows = self.trajectory()
        with open(path, "w") as f:
            for r in rows:
                _, x, y, z, qw, qx, qy, qz = r
                R = np.asarray(quat_to_matrix(
                    jnp.asarray([qw, qx, qy, qz], jnp.float32)))
                vals = np.concatenate(
                    [np.concatenate([R[i], [(x, y, z)[i]]]) for i in range(3)])
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    def save_keyframe_trajectory_tum(self, path):
        """Keyframe poses only (System::SaveKeyFrameTrajectoryTUM)."""
        from orb_slam3_study_kr_tpu.lie import se3
        from orb_slam3_study_kr_tpu.lie.so3 import matrix_to_quat
        m = self.atlas.active_map
        kfs = np.nonzero(m.kf_valid)[0]
        order = np.argsort(m.kf_timestamp[kfs])
        with open(path, "w") as f:
            for k in kfs[order]:
                R_wc, t_wc = se3.se3_inverse(
                    jnp.asarray(m.kf_R[k]), jnp.asarray(m.kf_t[k]))
                q = np.asarray(matrix_to_quat(R_wc))
                t = np.asarray(t_wc)
                f.write(f"{m.kf_timestamp[k]:.6f} "
                        f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    # ------------------------------------------------------------------
    ATLAS_ARRAY_FIELDS = [
        "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp",
        "kf_kp_uv", "kf_kp_level", "kf_kp_angle", "kf_kp_valid",
        "kf_desc", "kf_kp_patch", "kf_kp_ur", "kf_kp_lm", "lm_pos",
        "lm_valid", "lm_desc", "lm_patch", "lm_normal", "lm_min_dist",
        "lm_max_dist", "lm_first_kf", "lm_visible", "lm_found",
        "kf_redirect", "kf_redirect_R", "kf_redirect_t",
        "kf_v", "kf_bias",
    ]

    def save_atlas(self, path):
        """Whole-session checkpoint (System::SaveAtlas -> .osa equivalent,
        System.cc:1403-1443): every map's SoA arrays, the vocabulary with
        its checksum binding (System.cc:1508 role), the active map's loop
        edges, and the inertial session state (tracker bias/stage, the
        kf->kf preintegration chain and the raw IMU log) — a reloaded
        inertial session continues IMU-initialized without re-running the
        init schedule."""
        self.flush()
        payload = {"n_maps": np.int64(len(self.atlas.maps)),
                   "active": np.int64(self.atlas.active)}
        for i, m in enumerate(self.atlas.maps):
            for f_ in self.ATLAS_ARRAY_FIELDS:
                payload[f"map{i}/{f_}"] = getattr(m, f_)
            payload[f"map{i}/scalars"] = np.asarray(
                [m.n_kf, m.n_lm, m.next_lm, m.change_idx, m.map_id,
                 m.next_kf, int(m.imu_initialized), int(m.imu_ba2)])
        # Vocabulary + checksum (the inverted file is rebuilt exactly from
        # vocabulary + keyframe descriptors at load; what must persist and
        # bind is the vocabulary content itself).
        if self.voc is not None:
            from orb_slam3_study_kr_tpu.bow import vocabulary as _v
            for k, v in _v.vocabulary_arrays(self.voc).items():
                payload[f"voc/{k}"] = v
            payload["voc/md5"] = np.frombuffer(
                _v.vocabulary_checksum(self.voc).encode(), np.uint8)
        if self.loop_closer is not None and self.loop_closer.loop_edges:
            payload["loop_edges"] = np.asarray(
                self.loop_closer.loop_edges, np.int64)
        tr = self.tracker
        if self.cfg.sensor.endswith("-inertial"):
            payload["imu/bias"] = np.asarray(tr.bias, np.float32)
            payload["imu/stage"] = np.int64(tr.imu_stage)
            if tr.kf_imu:
                kf_ids = np.asarray(sorted(tr.kf_imu), np.int64)
                prev = np.asarray([tr.kf_imu[k][0] for k in kf_ids],
                                  np.int64)
                chunks = [np.asarray(tr.kf_imu[k][1], np.float32).reshape(
                    -1, 7) for k in kf_ids]
                offs = np.cumsum([0] + [c.shape[0] for c in chunks])
                payload["imu/chain_kf"] = kf_ids
                payload["imu/chain_prev"] = prev
                payload["imu/chain_rows"] = (
                    np.concatenate(chunks) if chunks
                    else np.zeros((0, 7), np.float32))
                payload["imu/chain_offs"] = offs.astype(np.int64)
            if tr._imu_log:
                ts = np.asarray([t for t, _ in tr._imu_log], np.float64)
                chunks = [np.asarray(r, np.float32).reshape(-1, 7)
                          for _, r in tr._imu_log]
                offs = np.cumsum([0] + [c.shape[0] for c in chunks])
                payload["imu/log_ts"] = ts
                payload["imu/log_rows"] = (
                    np.concatenate(chunks) if chunks
                    else np.zeros((0, 7), np.float32))
                payload["imu/log_offs"] = offs.astype(np.int64)
        np.savez_compressed(path, **payload)

    def load_atlas(self, path):
        """Rebuild the Atlas from a checkpoint; the active map resumes
        (System::LoadAtlas, System.cc:1445-1506): the persisted vocabulary
        is restored (never retrained) and — when the session also names a
        vocabulary file — bound by checksum exactly like the reference's
        MD5 check; the recognition inverted file is rebuilt from the
        restored vocabulary + keyframe descriptors; an inertial session's
        bias/stage/preintegration chain and raw IMU log come back so it
        continues IMU-initialized."""
        from orb_slam3_study_kr_tpu.slam_map.map_state import MapState

        data = np.load(path, allow_pickle=False)
        n_maps = int(data["n_maps"])
        self.atlas = Atlas()
        for i in range(n_maps):
            kf_valid = data[f"map{i}/kf_valid"]
            m = MapState(
                max_kf=kf_valid.shape[0],
                max_kp=data[f"map{i}/kf_desc"].shape[1],
                max_lm=data[f"map{i}/lm_pos"].shape[0],
            )
            for f_ in self.ATLAS_ARRAY_FIELDS:
                key = f"map{i}/{f_}"
                if key in data:
                    setattr(m, f_, data[key].copy())
            sc = data[f"map{i}/scalars"]
            m.n_kf, m.n_lm, m.next_lm, m.change_idx, m.map_id = (
                int(sc[0]), int(sc[1]), int(sc[2]), int(sc[3]), int(sc[4]))
            m.next_kf = int(sc[5]) if sc.size > 5 else int(m.n_kf)
            if sc.size > 7:
                m.imu_initialized = bool(sc[6])
                m.imu_ba2 = bool(sc[7])
            self.atlas.maps.append(m)
        self.atlas.active = int(data["active"])
        m = self.atlas.active_map
        self.local_mapper = LocalMapper(
            cfg=self.cfg.tracker, map=m,
            inertial_mode=self.cfg.sensor.endswith("-inertial"),
            on_kf_culled=self._on_kf_culled)
        self.tracker = self._build_tracker(m)
        self.tracker.async_map = self.async_map
        if self.cfg.sensor.endswith("-inertial"):
            self.local_mapper.inertial_ba = self.tracker.local_inertial_ba
            self._restore_imu_state(data)
        # Restore tracking against the loaded map via relocalization.
        self.tracker.state = TrackState.NOT_INITIALIZED if m.n_kf == 0 else TrackState.RECENTLY_LOST
        if m.n_kf:
            self.tracker.ref_kf = int(np.nonzero(m.kf_valid)[0][-1])
            # Recognition index: restore the PERSISTED vocabulary (checked
            # against any configured vocabulary file), rebuild the
            # inverted file from it.
            self.voc = None
            self.db = None
            self.loop_closer = None
            if "voc/kind" in data:
                self._restore_vocabulary(data)
            else:
                self._ensure_vocabulary()
            if self.loop_closer is not None and "loop_edges" in data:
                self.loop_closer.loop_edges = [
                    (int(a), int(b)) for a, b in data["loop_edges"]]
            # Seed a last_frame so reference-keyframe tracking has a pose.
            from orb_slam3_study_kr_tpu.pipeline.frame import Frame
            ref = self.tracker.ref_kf
            lf = Frame(
                frame_id=-1, timestamp=float(m.kf_timestamp[ref]),
                uv=m.kf_kp_uv[ref].copy(), level=m.kf_kp_level[ref].copy(),
                angle=m.kf_kp_angle[ref].copy(),
                response=np.zeros(m.max_kp, np.float32),
                desc=m.kf_desc[ref].copy(), valid=m.kf_kp_valid[ref].copy(),
            )
            lf.R_cw = m.kf_R[ref].copy()
            lf.t_cw = m.kf_t[ref].copy()
            lf.pose_ok = True
            self.tracker.last_frame = lf
            self.tracker.state = TrackState.RECENTLY_LOST

    def _restore_vocabulary(self, data):
        """Rebuild voc/db/loop-closer from the checkpoint's persisted
        vocabulary, enforcing the checksum binding (System.cc:1508)."""
        from orb_slam3_study_kr_tpu.bow import KeyframeDatabase
        from orb_slam3_study_kr_tpu.bow.vocabulary import (
            load_dbow2_text, load_vocabulary, vocabulary_checksum,
            vocabulary_from_arrays)
        from orb_slam3_study_kr_tpu.pipeline.loop_closing import LoopCloser

        z = {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith("voc/")}
        stored_md5 = bytes(z.pop("md5")).decode() if "md5" in z else None
        self.voc = vocabulary_from_arrays(z)
        if stored_md5 and vocabulary_checksum(self.voc) != stored_md5:
            raise ValueError("atlas checkpoint is corrupt: vocabulary "
                             "content does not match its stored checksum")
        if self.cfg.vocabulary_path is not None and stored_md5:
            p = str(self.cfg.vocabulary_path)
            cur = (load_dbow2_text(p) if p.endswith(".txt")
                   else load_vocabulary(p))
            if vocabulary_checksum(cur) != stored_md5:
                # The reference refuses to load an atlas built against a
                # different vocabulary (System.cc:169-177).
                raise ValueError(
                    "vocabulary checksum mismatch: the checkpoint was "
                    "built with a different vocabulary than "
                    f"{p}")
        m = self.atlas.active_map
        self.db = KeyframeDatabase(self.voc)
        self.map_dbs = {m.map_id: self.db}
        self.loop_closer = LoopCloser(
            cfg=self.cfg.tracker, map=m, db=self.db, ba_mesh=self.ba_mesh,
            inertial=self.cfg.sensor.endswith("-inertial"))
        for k in np.nonzero(m.kf_valid)[0]:
            self.db.add(int(k), m.kf_desc[k], m.kf_kp_valid[k])

    def _restore_imu_state(self, data):
        """Tracker-side inertial session state from the checkpoint."""
        tr = self.tracker
        if "imu/bias" in data:
            tr.bias = data["imu/bias"].copy()
        if "imu/stage" in data:
            tr.imu_stage = int(data["imu/stage"])
        if "imu/chain_kf" in data:
            kf_ids = data["imu/chain_kf"]
            prev = data["imu/chain_prev"]
            rows = data["imu/chain_rows"]
            offs = data["imu/chain_offs"]
            tr.kf_imu = {
                int(k): (int(prev[i]), rows[offs[i]:offs[i + 1]].copy())
                for i, k in enumerate(kf_ids)}
        if "imu/log_ts" in data:
            ts = data["imu/log_ts"]
            rows = data["imu/log_rows"]
            offs = data["imu/log_offs"]
            tr._imu_log = [
                (float(t), rows[offs[i]:offs[i + 1]].copy())
                for i, t in enumerate(ts)]

    def stats(self):
        m = self.atlas.active_map
        return dict(
            n_frames=self.tracker.stats["n_frames"],
            n_maps=len(self.atlas.maps),
            n_kf=int(m.kf_valid.sum()),
            n_lm=int(m.lm_valid.sum()),
            track_fail=self.tracker.stats["track_fail"],
            mapper=self.local_mapper.stats,
            loops=self.loop_closer.stats if self.loop_closer else {},
            mean_frame_ms=1e3 * float(np.mean(self.timings)) if self.timings else 0.0,
            stages=self.tracker.timers.summary(),
        )

    def print_time_stats(self):
        """Per-stage timing table (Tracking::PrintTimeStats role)."""
        print(self.tracker.timers.report())

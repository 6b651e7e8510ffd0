"""Monocular tracking front end.

Host orchestration of the jitted stages, mirroring the state machine of
/root/reference/src/Tracking.cc: monocular initialization (Tracking.cc:2469),
motion-model tracking (:2880), reference-keyframe fallback (:2745),
local-map tracking (:2977), keyframe decision (:3097).  All heavy compute
(ORB extraction, matching, pose solves) runs as fixed-shape jit ops; this
file only moves indices around.
"""

import enum
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_study_kr_tpu.cameras import pinhole
from orb_slam3_study_kr_tpu.cameras.twoview import reconstruct_two_views
from orb_slam3_study_kr_tpu.lie import se3
from orb_slam3_study_kr_tpu.ops import matching, orb, track_match
from orb_slam3_study_kr_tpu.pipeline.frame import Frame
from orb_slam3_study_kr_tpu.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu.solvers import bundle_adjust, optimize_pose


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


@dataclass
class TrackerConfig:
    width: int = 752
    height: int = 480
    fx: float = 458.0
    fy: float = 457.0
    cx: float = 376.0
    cy: float = 240.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3
    # Lens model ("pinhole" | "kb8").  For "kb8" (Kannala-Brandt fisheye,
    # reference src/CameraModels/KannalaBrandt8.cpp) `dist` holds k1..k4 and
    # the pipeline is FISHEYE-NATIVE: keypoints stay in raw fisheye pixels,
    # project_fn/project_jac_fn are the KB8 model (so matching gates,
    # pose-only GN, and every BA edge project in-model — the role of
    # ORBmatcher's pCamera->project and OptimizableTypes.h:31-117), and
    # triangulation runs on unprojected bearing rays (fisheye-safe DLT,
    # KannalaBrandt8::TriangulateMatches).  Features arbitrarily far
    # off-axis — past 90 deg on a 195-deg TUM-VI lens — contribute
    # everywhere.  Only the monocular two-view bootstrap restricts itself
    # to the central fov_max_deg cone (it maps those bearings onto a
    # virtual pinhole for the planar H/F machinery); after init the cone
    # plays no role.
    camera_model: str = "pinhole"
    fov_max_deg: float = 75.0       # mono-bootstrap central cone (kb8 only)
    fisheye_half_fov_deg: float = 98.0  # lens half-FOV visibility limit (kb8)
    fps: float = 20.0
    n_features: int = 1000
    # ORB pyramid/threshold knobs (reference ORBextractor.* settings keys).
    orb_n_levels: int = 8
    orb_scale_factor: float = 1.2
    orb_ini_th_fast: int = 20
    orb_min_th_fast: int = 7
    min_init_matches: int = 100
    min_track_matches: int = 12
    min_local_inliers: int = 25
    kf_ref_ratio: float = 0.9
    kf_min_gap: int = 2          # min frames between keyframes
    init_min_parallax: float = 1.5  # degrees; reference uses 1.0
    local_map_size: int = 4096
    bf: float = 0.0              # fx * stereo baseline; 0 = mono sensor
    patch_zncc_min: float = -1.0  # appearance gate on matches; <=-1 disables
    # (infrastructure for round-2 alignment-based verification: plain ZNCC
    # thresholds do not discriminate sub-texel shifts on smooth texture)
    # --- KLT match verification/refinement (ops/klt.py) ---
    # After descriptor NN, matches are photometrically aligned against the
    # landmark's canonical patch: sub-pixel observation refinement + an
    # appearance gate that actually discriminates (ZNCC measured *after*
    # alignment, so a low score means wrong content, not sub-texel shift).
    klt_refine: bool = True
    klt_zncc_min: float = 0.5    # reject matches below this aligned ZNCC
    klt_max_shift: float = 3.0   # level px; hitting the clamp = diverged
    # Write the aligned position back into the observation, gated by the
    # alias-ambiguity probe (ops/klt.py `distinct` output): only matches
    # whose aligned ZNCC beats every one-texture-cell-shifted probe by
    # klt_distinct_min move.  Ungated write-back *perfected* wrong
    # registrations on self-similar texture (the aligned uv supported the
    # wrong pose exactly, removing the residual the pose solve needed to
    # escape — a full tracking lock on the inertial oscillation world);
    # the distinctiveness margin restores the ~10% ATE gain on ordinary
    # texture while refusing to move ambiguous observations.
    klt_move_obs: bool = True
    klt_distinct_min: float = 0.15
    # Pose-solve weight for matches whose KLT alignment is NOT distinctive
    # (alias-ambiguous on self-similar texture).  1.0 = off; < 1 lets the
    # ambiguous set anchor the solve without outvoting the distinctive
    # observations into an aliased basin (fused-frame path only).
    ambig_obs_weight: float = 1.0
    mm_mature_only: bool = True  # motion model matches >=3-obs landmarks
    # Pose-free image-continuity anchor (see _flow_anchor_matches): match
    # last-frame bound features by descriptor inside a window centered at
    # their PREVIOUS observed position before any pose-gated search.
    flow_anchor: bool = True
    flow_anchor_radius: float = 40.0
    # Retrieval-anchored refinement: the reference keyframe's original
    # observations join the pose-free anchor set every frame (see
    # _fused_round_wide).  Default OFF: measured on lateral synthetic
    # worlds (3 seeds, round 5) the pose-free windows centered at the
    # KF-era positions ADMIT aliased matches on self-similar texture and
    # raise ATE ~60% (0.054 -> 0.094 mean); the channel is kept for
    # large-displacement recovery experiments only.
    refkf_anchor: bool = False
    # Run the local-map rounds through the fused single-dispatch program
    # (pipeline/fused_round.py) — same association/solve semantics, one
    # host sync per round instead of one per stage.
    fused_rounds: bool = True
    # Whole-frame fused slice (flow + motion model + local rounds in ONE
    # dispatch); falls back to the split path on low inliers.
    fused_frame: bool = True
    fused_local_rounds: int = 2   # local-map match/solve rounds in-program
    fused_th_wide: float = 3.0    # motion-model window radius (x sigma)
    # Pose sanity gate: reject a frame whose camera-center step exceeds
    # med_mult*median + std_mult*std of the recent steps (a coherent
    # aliased misregistration, not motion).  With the flow pre-solve the
    # retry is cheap and reliable, so the gate can run tight.
    sanity_med_mult: float = 3.0
    sanity_std_mult: float = 1.5
    seed: int = 0

    @functools.cached_property
    def cam_params(self):
        d = tuple(self.dist) + (0.0,) * (5 - len(self.dist))
        return jnp.asarray(
            [self.fx, self.fy, self.cx, self.cy, *d], jnp.float32
        )

    @functools.cached_property
    def ideal_params(self):
        if self.camera_model == "kb8":
            # Virtual pinhole: fov_max_deg half-angle maps to the half-width.
            f = 0.5 * min(self.width, self.height) / np.tan(
                np.radians(self.fov_max_deg))
            return jnp.asarray(
                [f, f, self.width / 2, self.height / 2, 0, 0, 0, 0, 0],
                jnp.float32)
        return jnp.asarray(
            [self.fx, self.fy, self.cx, self.cy, 0, 0, 0, 0, 0], jnp.float32
        )

    @functools.cached_property
    def K(self):
        p = np.asarray(self.ideal_params)
        return jnp.asarray(
            [[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]], jnp.float32
        )

    @functools.cached_property
    def orb_config(self):
        return orb.OrbConfig(
            n_features=self.n_features, height=self.height, width=self.width,
            n_levels=self.orb_n_levels, scale_factor=self.orb_scale_factor,
            fast_threshold=self.orb_ini_th_fast,
            fast_min_threshold=self.orb_min_th_fast,
        )

    @functools.cached_property
    def project_fn(self):
        if self.camera_model == "kb8":
            from orb_slam3_study_kr_tpu.cameras import kb8
            return functools.partial(kb8.project, self.cam_params)
        return functools.partial(pinhole.project, self.ideal_params)

    @functools.cached_property
    def project_jac_fn(self):
        if self.camera_model == "kb8":
            from orb_slam3_study_kr_tpu.cameras import kb8
            return functools.partial(kb8.project_jac, self.cam_params)
        return functools.partial(pinhole.project_jac, self.ideal_params)

    @functools.cached_property
    def undistort_px_fn(self):
        """Raw pixel coords -> the frame's native matching coords (raw
        itself for fisheye-native kb8, ideal undistorted pixels for
        pinhole).  Used in-program by the fused rounds to propagate KLT
        observation moves."""
        if self.camera_model == "kb8":
            return _identity_uv
        cam, ideal = self.cam_params, self.ideal_params

        def f(uv):
            return pinhole.project(ideal, pinhole.unproject(cam, uv))
        return f

    @functools.cached_property
    def unproject_fn(self):
        """Frame pixel coords -> bearing rays (matches the coordinate
        convention of frame.uv: raw fisheye pixels for kb8, ideal
        undistorted pixels for pinhole)."""
        if self.camera_model == "kb8":
            from orb_slam3_study_kr_tpu.cameras import kb8
            return functools.partial(kb8.unproject, self.cam_params)
        return functools.partial(pinhole.unproject, self.ideal_params)

    @property
    def max_theta_deg(self):
        """Off-axis visibility limit for projection gates (None = pinhole
        z > 0 frustum)."""
        if self.camera_model == "kb8":
            return float(self.fisheye_half_fov_deg)
        return None

    @property
    def focal(self):
        """Representative focal length (pixel units) for angular gates."""
        if self.camera_model == "kb8":
            return float(self.fx)
        return float(np.asarray(self.ideal_params)[0])


def _identity_uv(uv):
    """Module-level identity (stable hash for jit static args)."""
    return uv


def _np_se3_inverse(R, t):
    """Host-side SE3 inverse: 3x3 work on tiny matrices must not pay a
    device round trip in the per-frame path."""
    Rt = np.ascontiguousarray(R.T)
    return Rt, -(Rt @ t)


def _np_se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): apply b then a (host-side, see above)."""
    return Ra @ Rb, Ra @ tb + ta


@jax.jit
def _undistort(cam_params, ideal_params, uv):
    rays = pinhole.unproject(cam_params, uv)
    return pinhole.project(ideal_params, rays)


@jax.jit
def _ray_roundtrip_ok(cam_params, uv):
    """KB8 unprojection validity: Newton divergence / rays outside the lens
    model fail to reproject onto the source pixel."""
    from orb_slam3_study_kr_tpu.cameras import kb8
    rays = kb8.unproject(cam_params, uv)
    uv_back = kb8.project(cam_params, rays)
    err = jnp.linalg.norm(uv_back - uv, axis=-1)
    return err < 0.5


@jax.jit
def _kb8_central_virtual(cam_params, ideal_params, uv, fov_max_deg):
    """Fisheye keypoints -> virtual ideal-pinhole coordinates + centrality
    mask, used ONLY by the monocular two-view bootstrap (the H/F RANSAC
    machinery wants planar pinhole coordinates)."""
    from orb_slam3_study_kr_tpu.cameras import kb8
    rays = kb8.unproject(cam_params, uv)
    uv_ideal = pinhole.project(ideal_params, rays)
    uv_back = kb8.project(cam_params, rays)
    err = jnp.linalg.norm(uv_back - uv, axis=-1)
    theta = jnp.arctan2(jnp.linalg.norm(rays[..., :2], axis=-1),
                        rays[..., 2])
    ok = (err < 0.5) & (theta < jnp.radians(fov_max_deg))
    return uv_ideal, ok


def _pad_rows(a, n, fill=0):
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


class MonoTracker:
    """Tracking + (synchronous) mapping driver for one monocular camera."""

    def __init__(self, cfg: TrackerConfig, slam_map: MapState, local_mapper=None,
                 loop_closer=None, relocalizer=None, on_tracking_lost=None):
        self.cfg = cfg
        self.map = slam_map
        self.local_mapper = local_mapper
        self.async_map = None   # AsyncMapping backend (set by SlamSystem)
        self.loop_closer = loop_closer          # callable(kf_id) or None
        self.relocalizer = relocalizer          # callable(frame) -> bool
        self.on_tracking_lost = on_tracking_lost  # callable() -> None
        self.lost_counter = 0
        self.last_ok_ts = None  # timestamp of the last OK-tracked frame
        self.state = TrackState.NOT_INITIALIZED
        self.init_ref: Frame | None = None
        self.last_frame: Frame | None = None
        self.velocity = None  # (R, t) of T_cw(t) . T_wc(t-1)
        self.frame_count = 0
        self.last_kf_frame_id = -1
        self.ref_kf = -1
        self.trajectory = []  # (timestamp, ref_kf, T_rel_4x4, state)
        self.only_tracking = False  # localization mode: no map mutation
        self._speed_hist = []  # recent per-frame camera-center steps
        self._key = jax.random.PRNGKey(cfg.seed)
        self.stats = {"n_frames": 0, "n_kf": 0, "track_fail": 0,
                      "mm_fail": 0, "refkf_fail": 0, "local_fail": 0}
        from orb_slam3_study_kr_tpu.utils import StageTimers
        self.timers = StageTimers()
        from orb_slam3_study_kr_tpu.ops import klt as _klt
        self._level_wh = jnp.asarray(_klt.make_level_wh(cfg.orb_config))

    # ------------------------------------------------------------------
    def _extract_frame(self, img, timestamp) -> Frame:
        """ORB extraction + undistortion into a Frame (keeps the blurred
        pyramid on device when KLT match refinement is enabled)."""
        cfg = self.cfg
        pyr = None
        # Upload the image in its native dtype (uint8 for real cameras —
        # 4x less H2D traffic than float32 over the chip link); the
        # extractor casts on device.  A jax.Array passes through untouched:
        # callers can PREFETCH the upload during their own IO/render time
        # (SlamSystem.upload_image) so the transfer overlaps host work
        # instead of serializing ahead of this frame's programs.
        if isinstance(img, jax.Array):
            img_dev = img
        else:
            img_dev = jnp.asarray(img if np.asarray(img).dtype == np.uint8
                                  else np.asarray(img, np.float32))
        if cfg.klt_refine:
            feats, pyr = orb.extract_orb(
                img_dev, cfg.orb_config, with_pyramid=True)
        else:
            feats = orb.extract_orb(img_dev, cfg.orb_config)
        # np.array (not asarray): uv/uv_raw/patch are mutated in place by
        # the KLT refinement, and device->host views are read-only.
        valid_dev = feats.valid
        if cfg.camera_model == "kb8":
            # Fisheye-native: keypoints stay in raw fisheye pixels (the
            # KB8 project_fn consumes/produces the same coordinates).
            # Validity only drops rays whose Newton unprojection fails to
            # round-trip (degenerate beyond the lens model) — NOT an FOV
            # crop; >90 deg off-axis keypoints remain live.
            valid_dev = valid_dev & _ray_roundtrip_ok(cfg.cam_params,
                                                      feats.uv)
            uv_dev = feats.uv
        else:
            uv_dev = _undistort(cfg.cam_params, cfg.ideal_params, feats.uv)
        # DEFERRED batched fetch: tracked frames consume only the device
        # mirrors (fused rounds), so the host copies are materialized
        # lazily — in ONE round trip — the first time something reads
        # them (keyframe creation, init, relocalization).  np.array (not
        # asarray): uv/uv_raw/patch are mutated in place by the KLT
        # refinement, and device->host views are read-only.
        def fetch(feats=feats, uv_dev=uv_dev, valid_dev=valid_dev):
            uv_raw, uv_und, level, angle, response, desc, valid, patch = (
                jax.device_get((feats.uv, uv_dev, feats.level, feats.angle,
                                feats.response, feats.desc, valid_dev,
                                feats.patch)))
            return dict(uv=np.array(uv_und), uv_raw=np.array(uv_raw),
                        level=level, angle=angle, response=response,
                        desc=desc, valid=valid, patch=np.array(patch))

        frame = Frame(
            frame_id=self.frame_count,
            timestamp=timestamp,
            n_kp=cfg.orb_config.total_slots,
            fetch=fetch,
        )
        frame.pyr = pyr
        # Keep the extractor's device outputs resident for the jitted
        # match/optimize stages (no per-round re-upload).
        frame.set_dev("uv", uv_dev)
        frame.set_dev("uv_raw", feats.uv)
        frame.set_dev("level", feats.level)
        frame.set_dev("desc", feats.desc)
        frame.set_dev("valid", valid_dev)
        frame.set_dev("angle", feats.angle)
        self.frame_count += 1
        self.stats["n_frames"] += 1
        return frame

    def process(self, img, timestamp) -> Frame:
        with self.timers.stage("track/extract"):
            frame = self._extract_frame(img, timestamp)

        if self.state == TrackState.NOT_INITIALIZED:
            with self.timers.stage("track/initialize"):
                self._monocular_initialization(frame)
        else:
            with self.timers.stage("track/track"):
                self._track(frame)

        self._record_trajectory(frame)
        self.last_frame = frame
        return frame

    # ------------------------------------------------------------------
    def _monocular_initialization(self, frame: Frame):
        cfg = self.cfg
        if self.init_ref is None or self.init_ref.valid.sum() < cfg.min_init_matches:
            self.init_ref = frame
            return
        ref = self.init_ref
        idx, ok, _ = matching.search_for_initialization(
            ref.dev("uv"), ref.dev("desc"), ref.dev("angle"),
            ref.dev("valid"),
            frame.dev("uv"), frame.dev("desc"),
            frame.dev("angle"), frame.dev("valid"),
        )
        idx, ok = jax.device_get((idx, ok))
        if ok.sum() < cfg.min_init_matches:
            self.init_ref = frame
            return
        self._key, sub = jax.random.split(self._key)
        uv2 = frame.uv[idx]
        uv1_init, uv2_init = ref.uv, uv2
        if cfg.camera_model == "kb8":
            # Bootstrap on the central cone mapped to a virtual pinhole
            # (same camera center, so pts3d stay in true camera-1 coords).
            uv1_init, ok1 = _kb8_central_virtual(
                cfg.cam_params, cfg.ideal_params, jnp.asarray(ref.uv),
                jnp.float32(cfg.fov_max_deg))
            uv2_init, ok2 = _kb8_central_virtual(
                cfg.cam_params, cfg.ideal_params, jnp.asarray(uv2),
                jnp.float32(cfg.fov_max_deg))
            ok = ok & np.asarray(ok1) & np.asarray(ok2)
            if ok.sum() < cfg.min_init_matches:
                self.init_ref = frame
                return
        out = reconstruct_two_views(
            sub, jnp.asarray(uv1_init), jnp.asarray(uv2_init),
            jnp.asarray(ok.astype(np.float32)), self.cfg.K,
        )
        if not bool(out["success"]):
            return
        if float(out["parallax_deg"]) < cfg.init_min_parallax:
            # Keep waiting: more baseline means far better initial structure.
            return
        R21 = np.asarray(out["R21"])
        t21 = np.asarray(out["t21"])
        pts = np.asarray(out["pts3d"])
        good = np.asarray(out["good"]) & ok

        # Scale so median depth = 1 (CreateInitialMapMonocular's
        # invMedianDepth normalization).
        depths = pts[good][:, 2]
        med = float(np.median(depths))
        if med <= 0:
            return
        pts = pts / med
        t21 = t21 / med

        m = self.map
        eye = np.eye(3, dtype=np.float32)
        kf0 = m.add_keyframe(eye, np.zeros(3, np.float32), ref.uv, ref.level,
                             ref.angle, ref.valid, ref.desc, ref.frame_id,
                             ref.timestamp, patch=ref.patch)
        kf1 = m.add_keyframe(R21.astype(np.float32), t21.astype(np.float32),
                             frame.uv, frame.level, frame.angle, frame.valid,
                             frame.desc, frame.frame_id, frame.timestamp,
                             patch=frame.patch)
        gi = np.nonzero(good)[0].astype(np.int32)
        lm_ids = m.add_landmarks(pts[gi].astype(np.float32), ref.desc[gi], kf0,
                                 patches=ref.patch[gi])
        m.bind(kf0, gi, lm_ids)
        m.bind(kf1, idx[gi], lm_ids)
        m.update_landmark_stats(lm_ids)

        # Global BA over the 2-keyframe map (20 iterations, kf0 fixed).
        self._initial_global_ba(kf0, kf1)

        frame.R_cw = m.kf_R[kf1].copy()
        frame.t_cw = m.kf_t[kf1].copy()
        frame.kp_lm[idx[gi]] = lm_ids
        frame.pose_ok = True
        frame.ref_kf = kf1
        self.ref_kf = kf1
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackState.OK
        self.stats["n_kf"] = 2
        if self.local_mapper is not None:
            self.local_mapper.note_new_keyframe(kf0)
            self.local_mapper.note_new_keyframe(kf1)

    def _initial_global_ba(self, kf0, kf1):
        cfg, m = self.cfg, self.map
        okf, okp, olm = m.observations([kf0, kf1])
        lm_set = np.unique(olm)
        lm_index = np.full(m.max_lm, -1, np.int64)
        lm_index[lm_set] = np.arange(lm_set.size)
        O = okf.shape[0]
        R, t, X, chi2, _ = bundle_adjust(
            cfg.project_fn, cfg.project_jac_fn,
            jnp.asarray(m.kf_R[[kf0, kf1]]), jnp.asarray(m.kf_t[[kf0, kf1]]),
            jnp.asarray([1.0, 0.0]),
            jnp.asarray(m.lm_pos[lm_set]), jnp.ones(lm_set.size),
            jnp.asarray((okf == kf1).astype(np.int32)),
            jnp.asarray(lm_index[olm].astype(np.int32)),
            jnp.asarray(m.kf_kp_uv[okf, okp]),
            jnp.asarray(m.kf_kp_level[okf, okp]),
            jnp.ones(O),
            n_iters=20,
            wide_fov=cfg.camera_model == "kb8",
        )
        m.kf_R[[kf0, kf1]] = np.asarray(R)
        m.kf_t[[kf0, kf1]] = np.asarray(t)
        m.lm_pos[lm_set] = np.asarray(X)
        # Re-normalize scale (median depth in kf1).
        p = m.lm_pos[lm_set] @ m.kf_R[kf1].T + m.kf_t[kf1]
        med = float(np.median(p[:, 2]))
        if med > 0:
            m.lm_pos[lm_set] /= med
            m.kf_t[[kf0, kf1]] /= med

    # ------------------------------------------------------------------
    def _lost_pose_estimate(self, frame: Frame):
        """Pose guess for a frame that failed to track: keep the last pose
        so the next frame can try again (the visual-only behavior)."""
        frame.R_cw = self.last_frame.R_cw
        frame.t_cw = self.last_frame.t_cw
        frame.pose_ok = False

    def _lost_deadline_passed(self, frame: Frame) -> bool:
        """True when RECENTLY_LOST should escalate to LOST (visual-only:
        about one second of consecutive failures)."""
        return self.lost_counter > self.cfg.fps

    # ------------------------------------------------------------------
    def _update_last_frame(self):
        """Re-anchor the last frame's pose on its (possibly BA/loop-moved)
        reference keyframe (Tracking::UpdateLastFrame): without this, a map
        update between frames makes the frame-to-frame step look like a
        pose jump — tripping the sanity gate and biasing the velocity
        model."""
        lf = self.last_frame
        m = self.map
        if (lf is None or not lf.pose_ok
                or getattr(lf, "rel_ref", -1) < 0):
            return
        with m.lock:
            if m.change_idx == getattr(self, "_last_change_idx", -1):
                return
            self._last_change_idx = m.change_idx
            ref, Rrel, trel = m.resolve_kf(lf.rel_ref, lf.rel_R, lf.rel_t)
            if ref < 0:
                return
            Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
        lf.R_cw, lf.t_cw = _np_se3_compose(Rrel, trel, Rr, tr)

    def _track(self, frame: Frame):
        cfg, m = self.cfg, self.map
        self._update_last_frame()
        ok = False
        n_inliers = -1
        # Whole-frame fused slice: flow anchor + motion model (+ retry) +
        # both local-map rounds in ONE dispatch/fetch.  Falls back to the
        # split path when the frame genuinely diverges (few inliers).
        fused_frame = False
        if (cfg.fused_frame and self.velocity is not None
                and self.last_frame.pose_ok and self._use_fused_rounds()):
            n_inliers = self._track_fused_frame(frame)
            if n_inliers is not None and n_inliers >= cfg.min_local_inliers:
                ok = True
                fused_frame = True
                self.stats["fused_frame"] = (
                    self.stats.get("fused_frame", 0) + 1)
            else:
                if n_inliers is not None:
                    self.stats["fused_frame_fallback"] = (
                        self.stats.get("fused_frame_fallback", 0) + 1)
                n_inliers = -1
                frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM, np.int32)
        if not ok and self.velocity is not None and self.last_frame.pose_ok:
            ok = self._track_motion_model(frame)
            if not ok:
                self.stats["mm_fail"] += 1
        if not ok:
            # Reference-keyframe fallback; if the last frame has no pose
            # (RECENTLY_LOST), start from the reference keyframe's own pose
            # (the recovery role relocalization plays before BoW exists).
            ok = self._track_reference_kf(frame)
            if not ok:
                self.stats["refkf_fail"] += 1
        if not ok and self.relocalizer is not None:
            ok = self.relocalizer(frame)
        if not ok:
            self.state = TrackState.RECENTLY_LOST
            self.stats["track_fail"] += 1
            self.lost_counter += 1
            # Pose guess while lost: last pose (inertial trackers override
            # with IMU dead-reckoning, Tracking.cc:2000-2012).
            self._lost_pose_estimate(frame)
            self.velocity = None
            # Sustained loss: hand control to the Atlas (new map spawn /
            # reset — Tracking.cc:2028-2046 CreateMapInAtlas).  Never in
            # localization-only mode: the map is frozen, keep trying to
            # relocalize against it.
            if (not self.only_tracking
                    and self._lost_deadline_passed(frame)
                    and self.on_tracking_lost is not None):
                self.state = TrackState.LOST
                self.on_tracking_lost()
                self.lost_counter = 0
            return
        self.lost_counter = 0

        if not fused_frame:
            n_inliers = self._track_local_map(frame)
        if n_inliers < cfg.min_local_inliers:
            self.stats["local_fail"] += 1
            self.state = TrackState.RECENTLY_LOST
            self.stats["track_fail"] += 1
            frame.pose_ok = False
            self.velocity = None
            return

        # Pose sanity gate: a solved pose jumping far beyond the recent
        # frame-to-frame speed is a coherent mis-registration, not motion
        # (an aliasing lock "fits" hundreds of wrong matches, NOTES.md).
        # Reject the frame instead of poisoning trajectory + velocity.
        if self.last_frame.pose_ok:
            def _step_of(f):
                c_new = -f.R_cw.T @ f.t_cw
                c_old = -self.last_frame.R_cw.T @ self.last_frame.t_cw
                return float(np.linalg.norm(c_new - c_old))

            step = _step_of(frame)
            if len(self._speed_hist) >= 5:
                med = float(np.median(self._speed_hist))
                thresh = (cfg.sanity_med_mult * med
                          + cfg.sanity_std_mult * np.std(self._speed_hist))
                if med > 1e-9 and step > thresh:
                    # Before rejecting, retry once from the reference
                    # keyframe with fresh matches and no velocity prior —
                    # the wrong basin is usually entered via the motion-
                    # model match set, and a clean re-track recovers.
                    self.stats["sanity_retry"] = (
                        self.stats.get("sanity_retry", 0) + 1)
                    frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM,
                                          np.int32)
                    retry_ok = False
                    if fused_frame:
                        # Cheap in-program retry first: the same fused
                        # slice restarted from the LAST pose with no
                        # velocity prior (the wrong basin is usually
                        # entered via the motion-model prediction).
                        n2 = self._track_fused_frame(
                            frame, R_pred=np.asarray(self.last_frame.R_cw),
                            t_pred=np.asarray(self.last_frame.t_cw))
                        retry_ok = (n2 is not None
                                    and n2 >= cfg.min_local_inliers)
                        if retry_ok:
                            n_inliers = n2
                    if not retry_ok:
                        frame.kp_lm = np.full(frame.kp_lm.shape[0], NO_LM,
                                              np.int32)
                        retry_ok = self._track_reference_kf(frame)
                        if retry_ok:
                            n_inliers = self._track_local_map(frame)
                            retry_ok = n_inliers >= cfg.min_local_inliers
                    step = _step_of(frame) if retry_ok else np.inf
                    if step > thresh:
                        self.stats["sanity_fail"] = (
                            self.stats.get("sanity_fail", 0) + 1)
                        self.state = TrackState.RECENTLY_LOST
                        frame.pose_ok = False
                        frame.R_cw = self.last_frame.R_cw
                        frame.t_cw = self.last_frame.t_cw
                        self.velocity = None
                        return
            self._speed_hist.append(step)
            if len(self._speed_hist) > 10:
                self._speed_hist.pop(0)

        self.state = TrackState.OK
        frame.pose_ok = True
        frame.ref_kf = self.ref_kf
        self.last_ok_ts = frame.timestamp
        # Velocity model update.
        Rl, tl = self.last_frame.R_cw, self.last_frame.t_cw
        Rlw_inv, tlw_inv = _np_se3_inverse(np.asarray(Rl), np.asarray(tl))
        self.velocity = _np_se3_compose(
            np.asarray(frame.R_cw), np.asarray(frame.t_cw),
            Rlw_inv, tlw_inv)

        # Localization-only mode never inserts keyframes (the reference's
        # mbOnlyTracking, System::ActivateLocalizationMode System.h:118).
        if not self.only_tracking and self._need_new_keyframe(frame, n_inliers):
            self._create_keyframe(frame)

    # ------------------------------------------------------------------
    def _predict_pose(self):
        Rv, tv = self.velocity
        return _np_se3_compose(
            np.asarray(Rv), np.asarray(tv),
            np.asarray(self.last_frame.R_cw),
            np.asarray(self.last_frame.t_cw))

    def _match_against_landmarks(self, frame, lm_ids, R_pred, t_pred, th,
                                 wide_gates=False):
        """Project the given landmarks and match to the frame's keypoints."""
        cfg, m = self.cfg, self.map
        L = cfg.local_map_size if not wide_gates else 1024
        with m.lock:
            lm_ids = lm_ids[:L]
            pos = _pad_rows(m.lm_pos[lm_ids], L)
            desc = _pad_rows(m.lm_desc[lm_ids], L)
            mask = _pad_rows(np.ones(lm_ids.shape[0], np.float32), L)
            if wide_gates:
                # Frame-to-frame search skips the normal/band gates:
                # synthesize a normal pointing at the camera and an
                # unbounded band.
                center = -R_pred.T @ t_pred
                vec = pos - center
                nrm = vec / np.maximum(
                    np.linalg.norm(vec, axis=1, keepdims=True), 1e-9)
                normal = nrm.astype(np.float32)
                min_d = np.zeros(L, np.float32)
                max_d = np.full(L, 1e6, np.float32)
            else:
                normal = _pad_rows(m.lm_normal[lm_ids], L)
                min_d = _pad_rows(m.lm_min_dist[lm_ids], L)
                max_d = _pad_rows(m.lm_max_dist[lm_ids], L)
        lm_slot, ok, visible = track_match.match_local_map(
            cfg.project_fn, jnp.asarray(R_pred), jnp.asarray(t_pred),
            jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(min_d),
            jnp.asarray(max_d), jnp.asarray(desc), jnp.asarray(mask),
            frame.dev("uv"), frame.dev("level"),
            frame.dev("desc"), frame.dev("valid"),
            cfg.width, cfg.height, th=th,
            level_slack=7 if wide_gates else 1,
            max_theta_deg=cfg.max_theta_deg,
        )
        lm_slot, ok, visible = jax.device_get((lm_slot, ok, visible))
        matched_lm = np.where(ok, lm_ids[np.clip(lm_slot, 0, lm_ids.size - 1)], NO_LM)
        matched_lm = matched_lm.astype(np.int32)
        # Appearance verification: the match's oriented intensity patch must
        # correlate with the landmark's reference patch.  Descriptor NN on
        # self-similar texture can lock a coherent wrong registration
        # (NOTES.md); ZNCC on the raw patches breaks it.
        if cfg.patch_zncc_min > -1 and frame.patch is not None:
            sel = np.nonzero(matched_lm != NO_LM)[0]
            if sel.size:
                p1 = frame.patch[sel].astype(np.float32).reshape(sel.size, -1)
                p2 = m.lm_patch[matched_lm[sel]].astype(np.float32).reshape(
                    sel.size, -1)

                def _norm(p):
                    p = p - p.mean(1, keepdims=True)
                    return p / np.maximum(
                        np.linalg.norm(p, axis=1, keepdims=True), 1e-6)

                z = (_norm(p1) * _norm(p2)).sum(1)
                matched_lm[sel[z < cfg.patch_zncc_min]] = NO_LM
        matched_lm = self._klt_refine_matches(frame, matched_lm)
        return matched_lm, visible, lm_ids

    def _klt_refine_matches(self, frame, matched_lm):
        """Photometric verification + sub-pixel refinement of descriptor
        matches against the landmarks' canonical patches (ops/klt.py).
        Rejects matches whose *aligned* appearance still disagrees and
        moves accepted observations to the aligned position."""
        cfg, m = self.cfg, self.map
        if not cfg.klt_refine or frame.pyr is None:
            return matched_lm
        # Never re-align a keypoint that is already bound to a landmark: a
        # later matching round proposing a different landmark must not drag
        # the existing observation toward the other landmark's template.
        mask = (matched_lm != NO_LM) & (frame.kp_lm == NO_LM)
        if not mask.any():
            return matched_lm
        from orb_slam3_study_kr_tpu.ops import klt as _klt
        with m.lock:
            tmpl = m.lm_patch[np.clip(matched_lm, 0, m.max_lm - 1)]
        uv_ref, zncc, shift, win, distinct = _klt.klt_refine(
            frame.pyr, self._level_wh, jnp.asarray(frame.uv_raw),
            frame.dev("level"), frame.dev("angle"),
            jnp.asarray(tmpl), jnp.asarray(mask),
            max_shift=cfg.klt_max_shift)
        if cfg.klt_move_obs:
            uv_ref, zncc, shift, win, distinct = jax.device_get(
                (uv_ref, zncc, shift, win, distinct))
        else:
            zncc, shift = jax.device_get((zncc, shift))
        good = mask & (zncc >= cfg.klt_zncc_min) & (shift < cfg.klt_max_shift)
        if good.any() and cfg.klt_move_obs:
            # Anti-aliasing gate: only move observations whose aligned
            # position is DISTINCTIVE — on self-similar texture a shifted
            # probe scores almost as well and the write-back would lock a
            # wrong registration in (the regression that kept this off).
            move = good & (distinct >= cfg.klt_distinct_min)
            self.stats["klt_ambiguous"] = (
                self.stats.get("klt_ambiguous", 0)
                + int((good & ~move).sum()))
            uv_ref = np.asarray(uv_ref)
            du = uv_ref[:, 0] - frame.uv_raw[:, 0]
            frame.uv_raw[move] = uv_ref[move]
            if cfg.camera_model == "kb8":
                und = uv_ref  # fisheye-native frames keep raw pixel coords
            else:
                und = np.asarray(_undistort(cfg.cam_params, cfg.ideal_params,
                                            jnp.asarray(uv_ref)))
            frame.uv[move] = und[move]
            frame.invalidate_dev("uv")
            # Stereo: carry the right-image coordinate along (the disparity
            # was measured at the pre-refinement left position).
            if frame.u_r is not None:
                has_r = move & (frame.u_r >= 0)
                frame.u_r[has_r] += du[has_r]
            if frame.patch is not None:
                frame.patch[move] = np.clip(
                    np.asarray(win), 0, 255).astype(np.uint8)[move]
        out = matched_lm.copy()
        out[mask & ~good] = NO_LM
        self.stats["klt_reject"] = (
            self.stats.get("klt_reject", 0) + int((mask & ~good).sum()))
        return out

    def _optimize_frame_pose(self, frame, R0, t0):
        cfg, m = self.cfg, self.map
        with m.lock:
            # Drop bindings to landmarks removed since they were made.
            stale = (frame.kp_lm != NO_LM) & ~m.lm_valid[
                np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            frame.kp_lm = np.where(stale, NO_LM,
                                   frame.kp_lm).astype(np.int32)
            X = m.lm_pos[np.clip(frame.kp_lm, 0, m.max_lm - 1)]
        mask = (frame.kp_lm != NO_LM) & frame.valid
        stereo_kw = {}
        if cfg.bf > 0 and frame.u_r is not None:
            stereo_kw = dict(ur_obs=jnp.asarray(frame.u_r),
                             bf=jnp.float32(cfg.bf))
        R, t, inl, n_inl = optimize_pose(
            cfg.project_fn, cfg.project_jac_fn,
            jnp.asarray(R0), jnp.asarray(t0),
            jnp.asarray(X), frame.dev("uv"),
            frame.dev("level"), jnp.asarray(mask.astype(np.float32)),
            wide_fov=cfg.camera_model == "kb8",
            **stereo_kw,
        )
        R, t, inl = jax.device_get((R, t, inl))
        inl = inl & mask
        frame.R_cw = np.array(R)
        frame.t_cw = np.array(t)
        # Unbind outliers (reference clears mvpMapPoints for outliers).
        frame.kp_lm = np.where(inl, frame.kp_lm, NO_LM).astype(np.int32)
        return int(inl.sum())

    def _flow_anchor_matches(self, frame: Frame):
        """Pose-FREE association channel: windowed descriptor matching
        centered at each bound feature's position in the LAST frame (image
        continuity), not at its pose-projected position.  The pose-gated
        search windows are exactly what the drift feedback loop rides (a
        biased pose shifts the windows, true matches drop out, the pose
        slides further — NOTES.md); this channel re-anchors every frame to
        where the features actually were, immune to the pose estimate.
        Bindings still pass the KLT photometric verification."""
        cfg, m = self.cfg, self.map
        lf = self.last_frame
        if not cfg.flow_anchor or lf is None:
            return
        with m.lock:
            bound = (lf.kp_lm != NO_LM) & lf.valid
            bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
        if bound.sum() < 3:
            return
        idx, ok, _ = matching.search_for_initialization(
            lf.dev("uv"), lf.dev("desc"), lf.dev("angle"),
            jnp.asarray(bound),
            frame.dev("uv"), frame.dev("desc"), frame.dev("angle"),
            frame.dev("valid"),
            window_radius=cfg.flow_anchor_radius, nn_ratio=0.8,
        )
        idx, ok = jax.device_get((idx, ok))
        sel = np.nonzero(ok & bound)[0]
        if sel.size == 0:
            return
        # First-wins on contested current keypoints.
        new_kp, first = np.unique(idx[sel], return_index=True)
        lm = lf.kp_lm[sel[first]]
        cand = np.full(frame.uv.shape[0], NO_LM, np.int32)
        cand[new_kp] = lm
        cand = self._klt_refine_matches(frame, cand)
        take = (cand != NO_LM) & (frame.kp_lm == NO_LM)
        frame.kp_lm = np.where(take, cand, frame.kp_lm).astype(np.int32)
        self.stats["flow_anchor_matches"] = (
            self.stats.get("flow_anchor_matches", 0) + int(take.sum()))

    def _track_motion_model(self, frame: Frame) -> bool:
        cfg, m = self.cfg, self.map
        R_pred, t_pred = self._predict_pose()
        kp, lms = self.last_frame.bound_obs()
        if lms.size < 3:
            return False
        use_fused = self._use_fused_rounds()
        if not use_fused:
            # Fused mode runs the flow anchor as an in-program prologue of
            # the motion-model dispatch instead of two extra round trips.
            self._flow_anchor_matches(frame)
        with m.lock:
            lm_ids = np.unique(lms)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            # Prefer mature landmarks (>= 3 keyframe observations): freshly
            # triangulated 2-obs points have the largest position error and
            # a coherent bias in them can drag the pose solve into a wrong
            # basin (observed at KF+2 on self-similar texture).  Fall back
            # to all when the mature subset is too small (e.g. right after
            # init).
            if cfg.mm_mature_only:
                obs = m.landmark_obs_count()
                mature = lm_ids[obs[lm_ids] >= 3]
                if mature.size >= 2 * cfg.min_track_matches:
                    lm_ids = mature
            # Exclude landmarks the flow channel already bound.
            _, bound_now = frame.bound_obs()
            if bound_now.size:
                lm_ids = lm_ids[~np.isin(lm_ids, bound_now)]
        if use_fused:
            # Single-dispatch round (flow anchor + match + verify + bind +
            # solve); the wide-gate geometry is synthesized into the
            # landmark block.
            n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred,
                                       th=3.0, with_flow=True)
            if n < cfg.min_track_matches:
                n = self._fused_round_wide(frame, lm_ids, R_pred, t_pred,
                                           th=6.0)
            return n >= cfg.min_track_matches
        matched_lm, _, _ = self._match_against_landmarks(
            frame, lm_ids, R_pred, t_pred, th=3.0, wide_gates=True
        )
        free = frame.kp_lm == NO_LM
        frame.kp_lm = np.where(free, matched_lm, frame.kp_lm).astype(np.int32)
        if (frame.kp_lm != NO_LM).sum() < cfg.min_track_matches:
            # Widen the window once, as the reference does.
            matched_lm, _, _ = self._match_against_landmarks(
                frame, lm_ids, R_pred, t_pred, th=6.0, wide_gates=True
            )
            free = frame.kp_lm == NO_LM
            frame.kp_lm = np.where(free, matched_lm,
                                   frame.kp_lm).astype(np.int32)
        if (frame.kp_lm != NO_LM).sum() < cfg.min_track_matches:
            return False
        n = self._optimize_frame_pose(frame, R_pred, t_pred)
        return n >= cfg.min_track_matches

    def _track_reference_kf(self, frame: Frame) -> bool:
        cfg, m = self.cfg, self.map
        kf = self.ref_kf
        if kf < 0:
            return False
        # Projection search of the reference keyframe's landmarks with wide
        # gates from the last known pose; fall back to global descriptor
        # matching (the BoW-style path) if that fails.
        with m.lock:
            lms = m.kf_kp_lm[kf]
            lm_ids = np.unique(lms[lms != NO_LM])
            lm_ids = lm_ids[self.map.lm_valid[lm_ids]]
        matched_lm = np.full(frame.uv.shape[0], NO_LM, np.int32)
        if lm_ids.size >= 3:
            R0, t0 = (
                (self.last_frame.R_cw, self.last_frame.t_cw)
                if self.last_frame.pose_ok
                else (m.kf_R[kf], m.kf_t[kf])
            )
            matched_lm, _, _ = self._match_against_landmarks(
                frame, lm_ids, R0, t0, th=10.0, wide_gates=True
            )
        if (matched_lm != NO_LM).sum() < cfg.min_track_matches:
            bound = m.kf_kp_lm[kf] != NO_LM
            idx, ok, _ = track_match.match_by_descriptor(
                frame.dev("desc"), frame.dev("valid"),
                jnp.asarray(m.kf_desc[kf]),
                jnp.asarray(m.kf_kp_valid[kf] & bound),
            )
            idx, ok = jax.device_get((idx, ok))
            matched_lm = np.where(ok, m.kf_kp_lm[kf][idx], NO_LM).astype(np.int32)
        if (matched_lm != NO_LM).sum() < cfg.min_track_matches:
            return False
        frame.kp_lm = matched_lm
        if self.last_frame.pose_ok:
            R0, t0 = self.last_frame.R_cw, self.last_frame.t_cw
        else:
            R0, t0 = m.kf_R[kf], m.kf_t[kf]
        n = self._optimize_frame_pose(frame, R0, t0)
        return n >= cfg.min_track_matches

    def _track_local_map(self, frame: Frame) -> int:
        cfg, m = self.cfg, self.map
        # Local keyframes: those observing the frame's current landmarks,
        # plus their covisibility neighbors (UpdateLocalKeyFrames K1+K2).
        _, lms = frame.bound_obs()
        if lms.size == 0:
            return 0
        with m.lock:
            seen = np.zeros(m.max_lm, bool)
            seen[lms] = True
            obs_count = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).sum(axis=1)
            obs_count[~m.kf_valid] = 0
            k1 = np.nonzero(obs_count > 0)[0]
            if k1.size == 0:
                return 0
            self.ref_kf = int(k1[np.argmax(obs_count[k1])])
            frame.ref_kf = self.ref_kf
            local_kfs = set(k1.tolist())
            for kf in k1[np.argsort(-obs_count[k1])][:10]:
                nb, _ = m.covisibility(int(kf), min_shared=15)
                local_kfs.update(nb[:10].tolist())
            local_kfs = np.fromiter(local_kfs, np.int32)
            # Local landmarks not already bound in this frame, ordered by
            # the covisibility weight of their keyframes so that truncation
            # to the matcher's fixed capacity drops the least-relevant ones
            # (truncating by landmark id would age the current view out of
            # the local map).
            order = local_kfs[np.argsort(-obs_count[local_kfs],
                                         kind="stable")]
            seen_lm = np.zeros(m.max_lm, bool)
            chunks = []
            for kf_i in order:
                c = m.kf_kp_lm[kf_i]
                c = c[c != NO_LM]
                c = c[~seen_lm[c]]
                seen_lm[c] = True
                chunks.append(c)
            cand = np.concatenate(chunks) if chunks else np.empty(0, np.int32)
            cand = cand[m.lm_valid[cand]]
            cand = cand[~np.isin(cand, lms)]
        if self._use_fused_rounds():
            return self._track_local_map_fused(frame, cand)
        matched_lm, visible, used_ids = self._match_against_landmarks(
            frame, cand, frame.R_cw, frame.t_cw, th=1.0
        )
        # Visibility statistics for culling.
        vis_ids = used_ids[np.asarray(visible)[: used_ids.size]]
        m.lm_visible[vis_ids] += 1
        # Merge: keep existing bindings, add new ones on free keypoints.
        free = frame.kp_lm == NO_LM
        frame.kp_lm = np.where(free, matched_lm, frame.kp_lm).astype(np.int32)
        n = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
        # Second match<->optimize round: with the refined pose the search
        # windows re-center, so true matches that the biased prediction
        # pushed outside the gate re-enter (breaks the pose-gated match-
        # selection feedback loop, NOTES.md).
        _, lms_now = frame.bound_obs()
        cand2 = cand[~np.isin(cand, lms_now)]
        matched2, _, _ = self._match_against_landmarks(
            frame, cand2, frame.R_cw, frame.t_cw, th=1.0
        )
        free = frame.kp_lm == NO_LM
        add = free & (matched2 != NO_LM)
        if add.any():
            frame.kp_lm = np.where(add, matched2, frame.kp_lm).astype(np.int32)
            n = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw)
        _, lms_after = frame.bound_obs()
        m.lm_found[lms_after] += 1
        return n

    def _custom_pose_opt_active(self) -> bool:
        """True when a subclass replaces the visual pose solve with its own
        (e.g. the pose-inertial solves after IMU init) — the fused round's
        in-program visual GN must then yield to the split path so the
        custom solve stays in the loop."""
        return False

    def _use_fused_rounds(self) -> bool:
        """The fused program covers the split path's semantics except the
        raw patch-ZNCC appearance gate (off by default); when that gate is
        enabled the split path must run so it is honored."""
        return (self.cfg.fused_rounds
                and self.cfg.patch_zncc_min <= -1
                and not self._custom_pose_opt_active())

    def _build_lm_block(self, cand, L, wide_gates=False,
                        R_pred=None, t_pred=None):
        """Padded device-resident landmark block for the fused round."""
        m = self.map
        with m.lock:
            return self._build_lm_block_locked(cand, L, wide_gates,
                                               R_pred, t_pred)

    def _build_lm_block_locked(self, cand, L, wide_gates, R_pred, t_pred):
        m = self.map
        cand = cand[:L]
        pos = m.lm_pos[cand]
        if wide_gates:
            # Frame-to-frame search skips the normal/band gates: a normal
            # pointing at the camera and an unbounded band.
            center = -R_pred.T @ t_pred
            vec = pos - center
            nrm = vec / np.maximum(
                np.linalg.norm(vec, axis=1, keepdims=True), 1e-9)
            normal = _pad_rows(nrm.astype(np.float32), L)
            min_d = np.zeros(L, np.float32)
            max_d = np.full(L, 1e6, np.float32)
        else:
            normal = _pad_rows(m.lm_normal[cand], L)
            min_d = _pad_rows(m.lm_min_dist[cand], L)
            max_d = _pad_rows(m.lm_max_dist[cand], L)
        gid = np.full(L, NO_LM, np.int32)
        gid[: cand.size] = cand
        blk_mask = _pad_rows(np.ones(cand.shape[0], np.float32), L)
        block = dict(
            lm_pos=jnp.asarray(_pad_rows(pos, L)),
            lm_normal=jnp.asarray(normal),
            lm_min_dist=jnp.asarray(min_d),
            lm_max_dist=jnp.asarray(max_d),
            lm_desc=jnp.asarray(_pad_rows(m.lm_desc[cand], L)),
            lm_patch=jnp.asarray(_pad_rows(m.lm_patch[cand], L)),
            lm_gid=jnp.asarray(gid),
        )
        return block, blk_mask, cand

    def _refresh_fused_block(self, lm_ids, L):
        """(Re)build the cached fused-frame candidate block.  Called under
        the map lock whenever the map's change_idx moved.  The device
        arrays are POSE-FREE (wide gates are synthesized in-program from
        the predicted center), so they stay valid until the next map
        change — per-frame prep is then just index ops + tiny uploads."""
        cfg, m = self.cfg, self.map
        obs = m.landmark_obs_count()
        # Local keyframes from the anchor landmark set
        # (UpdateLocalKeyFrames K1+K2, one frame behind).
        seen = np.zeros(m.max_lm, bool)
        seen[lm_ids] = True
        obs_count = (seen[m.kf_kp_lm] & (m.kf_kp_lm != NO_LM)).sum(axis=1)
        obs_count[~m.kf_valid] = 0
        k1 = np.nonzero(obs_count > 0)[0]
        if k1.size == 0:
            return None
        ref_kf = int(k1[np.argmax(obs_count[k1])])
        local_kfs = set(k1.tolist())
        for kf_i in k1[np.argsort(-obs_count[k1])][:10]:
            nb, _ = m.covisibility(int(kf_i), min_shared=15)
            local_kfs.update(nb[:10].tolist())
        local_kfs = np.fromiter(local_kfs, np.int32)
        order = local_kfs[np.argsort(-obs_count[local_kfs], kind="stable")]
        seen_lm = np.zeros(m.max_lm, bool)
        seen_lm[lm_ids] = True
        chunks = [lm_ids.astype(np.int32)]  # anchor rows first: never
        for kf_i in order:                  # truncated out of the block
            c = m.kf_kp_lm[kf_i]
            c = c[c != NO_LM]
            c = c[~seen_lm[c]]
            seen_lm[c] = True
            chunks.append(c)
        cand = np.concatenate(chunks)
        cand = cand[m.lm_valid[cand]][:L]
        gid = np.full(L, NO_LM, np.int32)
        gid[: cand.size] = cand
        row_of = np.full(m.max_lm, -1, np.int32)
        row_of[cand] = np.arange(cand.size, dtype=np.int32)
        blk = dict(
            change_idx=m.change_idx, member_idx=m.member_idx, map_ref=m,
            cand=cand, ref_kf=ref_kf, row_of=row_of, obs=obs,
            pos=jnp.asarray(_pad_rows(m.lm_pos[cand], L)),
            desc=jnp.asarray(_pad_rows(m.lm_desc[cand], L)),
            gid=jnp.asarray(gid),
            patch=jnp.asarray(_pad_rows(m.lm_patch[cand], L)),
            normal=jnp.asarray(_pad_rows(m.lm_normal[cand], L)),
            min_d=jnp.asarray(_pad_rows(m.lm_min_dist[cand], L)),
            max_d=jnp.asarray(_pad_rows(m.lm_max_dist[cand], L)),
            mask_all=jnp.asarray(
                _pad_rows(np.ones(cand.size, np.float32), L)),
        )
        self._fblk = blk
        return blk

    def _geo_refresh_fused_block(self, blk):
        """Cheap per-change refresh: membership (and so row layout,
        descriptors, patches) is unchanged — only geometry, validity and
        observation counts moved (local BA, culling, stats updates, loop
        corrections).  Re-uploads ~150 KB instead of the ~1.6 MB full
        block."""
        m = self.map
        cand = blk["cand"]
        L = blk["pos"].shape[0]
        blk["pos"] = jnp.asarray(_pad_rows(m.lm_pos[cand], L))
        blk["normal"] = jnp.asarray(_pad_rows(m.lm_normal[cand], L))
        blk["min_d"] = jnp.asarray(_pad_rows(m.lm_min_dist[cand], L))
        blk["max_d"] = jnp.asarray(_pad_rows(m.lm_max_dist[cand], L))
        blk["mask_all"] = jnp.asarray(_pad_rows(
            m.lm_valid[cand].astype(np.float32), L))
        blk["obs"] = m.landmark_obs_count()
        blk["change_idx"] = m.change_idx

    def _track_fused_frame(self, frame: Frame, R_pred=None, t_pred=None):
        """The whole per-frame tracking slice in ONE dispatch + ONE fetch
        (pipeline/fused_round.fused_track_frame): flow anchor + motion
        model (with in-program widened retry) + both local-map rounds.

        The local-map candidate block and reference-keyframe choice come
        from the LAST frame's bindings (one-frame lag vs the split path's
        post-motion-model selection — image continuity makes the sets
        near-identical); the caller falls back to the split path when
        the fetch reports too few inliers.  The block's device arrays are
        CACHED across frames and rebuilt only when the map's change_idx
        moves — between map updates every binding is a block member, so
        per-frame prep reduces to index lookups.  Returns the inlier
        count, or None when the fused slice is not applicable."""
        from orb_slam3_study_kr_tpu.pipeline.fused_round import (
            fused_track_frame)
        cfg, m = self.cfg, self.map
        lf = self.last_frame
        if R_pred is None:
            R_pred, t_pred = self._predict_pose()
        use_klt = cfg.klt_refine and frame.pyr is not None
        L = cfg.local_map_size
        with m.lock:
            kp, lms = lf.bound_obs()
            lm_ids = np.unique(lms)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 3:
                self.stats["fused_bail_anchor"] = (
                    self.stats.get("fused_bail_anchor", 0) + 1)
                return None
            blk = getattr(self, "_fblk", None)
            if (blk is None or blk["map_ref"] is not m
                    or blk["member_idx"] != m.member_idx):
                blk = self._refresh_fused_block(lm_ids, L)
                if blk is None:
                    self.stats["fused_bail_refresh"] = (
                        self.stats.get("fused_bail_refresh", 0) + 1)
                    return None
            elif blk["change_idx"] != m.change_idx:
                self._geo_refresh_fused_block(blk)
            if cfg.mm_mature_only:
                mature = lm_ids[blk["obs"][lm_ids] >= 3]
                if mature.size >= 2 * cfg.min_track_matches:
                    lm_ids = mature
            self.ref_kf = blk["ref_kf"]
            frame.ref_kf = self.ref_kf
            cand, row_of = blk["cand"], blk["row_of"]
            wrows = row_of[lm_ids]
            if (wrows < 0).sum() * 2 > lm_ids.size:
                # Most anchors left the cached block (split-path bindings
                # outside it): rebuild around the current anchor set.
                blk = self._refresh_fused_block(lm_ids, L)
                if blk is None:
                    self.stats["fused_bail_refresh"] = (
                        self.stats.get("fused_bail_refresh", 0) + 1)
                    return None
                self.ref_kf = blk["ref_kf"]
                frame.ref_kf = self.ref_kf
                cand, row_of = blk["cand"], blk["row_of"]
                wrows = row_of[lm_ids]
            in_wide = np.zeros(L, np.float32)
            in_wide[wrows[wrows >= 0]] = 1.0

            flow = None
            if cfg.flow_anchor:
                # kp_lm bindings are only ever created on valid keypoints
                # (every matcher gates on f_valid in-program), so the
                # validity AND is consulted only when the host array is
                # already materialized — touching lf.valid on a lazy frame
                # would trigger the deferred extractor fetch (a device
                # sync) on EVERY tracked frame.
                bound = lf.kp_lm != NO_LM
                lf_valid = lf._host.get("valid")
                if lf_valid is not None:
                    bound &= lf_valid
                bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
                if bound.sum() >= 3:
                    fgid = np.where(bound, lf.kp_lm, NO_LM).astype(np.int32)
                    cl = np.clip(fgid, 0, m.max_lm - 1)
                    flow = (lf.dev("uv"), lf.dev("desc"), lf.dev("angle"),
                            jnp.asarray(bound), jnp.asarray(fgid),
                            jnp.asarray(row_of[cl]))

            stereo_kw = {}
            if cfg.bf > 0 and frame.u_r is not None:
                stereo_kw = dict(ur_obs=jnp.asarray(frame.u_r),
                                 bf=jnp.float32(cfg.bf))
            out = fused_track_frame(
                cfg.project_fn, cfg.project_jac_fn, cfg.undistort_px_fn,
                jnp.asarray(R_pred), jnp.asarray(t_pred),
                blk["pos"], blk["desc"], blk["gid"], blk["patch"],
                blk["normal"], blk["min_d"], blk["max_d"],
                blk["mask_all"], jnp.asarray(in_wide),
                jnp.asarray(frame.kp_lm),
                jnp.zeros((frame.kp_lm.shape[0], 3), jnp.float32),
                frame.dev("uv"), frame.dev("level"), frame.dev("desc"),
                frame.dev("valid"), frame.dev("uv_raw"),
                frame.dev("angle"),
                frame.pyr if use_klt else jnp.zeros((1, 2, 2), jnp.float32),
                self._level_wh if use_klt else jnp.ones((1, 2), jnp.float32),
                cfg.width, cfg.height,
                jnp.int32(cfg.min_track_matches),
                th_wide=cfg.fused_th_wide,
                n_local_rounds=cfg.fused_local_rounds,
                scale_factor=cfg.orb_scale_factor,
                n_levels=cfg.orb_n_levels,
                max_theta_deg=cfg.max_theta_deg,
                klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min,
                wide_fov=cfg.camera_model == "kb8",
                use_klt=use_klt,
                move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius,
                R_last=(jnp.asarray(lf.R_cw) if flow is not None else None),
                t_last=(jnp.asarray(lf.t_cw) if flow is not None else None),
                ambig_w=(cfg.ambig_obs_weight
                         if use_klt and cfg.ambig_obs_weight < 1.0
                         else None),
                **stereo_kw,
            )
        uv_dev, uv_raw_dev = out[6][0], out[6][1]
        (R, t, kp_lm, inl, visible, n_mm,
         (uv_new, uv_raw_new, ur_new, moved), n_flow) = jax.device_get(out)
        if int(n_mm) < cfg.min_track_matches:
            # The split path's motion-model gate: a frame whose wide
            # rounds could not bind enough matches must go through the
            # reference-keyframe fallback, not a local solve around a
            # weak pose.
            self.stats["fused_bail_mm"] = (
                self.stats.get("fused_bail_mm", 0) + 1)
            return None
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = np.array(R)
        frame.t_cw = np.array(t)
        frame.kp_lm = np.array(kp_lm)
        if moved.any():
            frame.fill_host(uv=np.array(uv_new),
                            uv_raw=np.array(uv_raw_new))
            frame.set_dev("uv", uv_dev)
            frame.set_dev("uv_raw", uv_raw_dev)
            if frame.u_r is not None and ur_new is not None:
                frame.u_r[:] = ur_new
        with m.lock:
            vis = visible[: cand.size]
            m.lm_visible[cand[vis]] += 1
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return int(inl.sum())

    def _exec_fused_rounds(self, frame, block, blk_mask, R0, t0, th,
                           level_slack, n_rounds=1, flow=None):
        """Dispatch n_rounds complete rounds in ONE program (optionally
        with the flow-anchor prologue), fetch once, apply pose/bindings/
        KLT moves on the host.  Returns (n_inliers, visible_round1)."""
        from orb_slam3_study_kr_tpu.pipeline.fused_round import (
            fused_track_rounds)
        cfg, m = self.cfg, self.map
        use_klt = cfg.klt_refine and frame.pyr is not None
        stereo_kw = {}
        if cfg.bf > 0 and frame.u_r is not None:
            stereo_kw = dict(ur_obs=jnp.asarray(frame.u_r),
                             bf=jnp.float32(cfg.bf))
        # Drop stale bindings, gather bound landmark positions (map reads
        # under the map-update lock; the dispatch is non-blocking and the
        # fetch below waits with the lock released).
        with m.lock:
            stale = (frame.kp_lm != NO_LM) & ~m.lm_valid[
                np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            frame.kp_lm = np.where(stale, NO_LM, frame.kp_lm).astype(np.int32)
            kp_lm_pos = m.lm_pos[np.clip(frame.kp_lm, 0, m.max_lm - 1)]
            out = fused_track_rounds(
                cfg.project_fn, cfg.project_jac_fn, cfg.undistort_px_fn,
                jnp.asarray(R0), jnp.asarray(t0),
                block["lm_pos"], block["lm_normal"], block["lm_min_dist"],
                block["lm_max_dist"], block["lm_desc"],
                jnp.asarray(blk_mask), block["lm_gid"], block["lm_patch"],
                jnp.asarray(frame.kp_lm), jnp.asarray(kp_lm_pos),
                frame.dev("uv"), frame.dev("level"), frame.dev("desc"),
                frame.dev("valid"),
                frame.dev("uv_raw"), frame.dev("angle"),
                frame.pyr if use_klt else jnp.zeros((1, 2, 2), jnp.float32),
                self._level_wh if use_klt else jnp.ones((1, 2), jnp.float32),
                cfg.width, cfg.height, th=th,
                scale_factor=cfg.orb_scale_factor,
                n_levels=cfg.orb_n_levels, level_slack=level_slack,
                max_theta_deg=cfg.max_theta_deg,
                klt_zncc_min=cfg.klt_zncc_min,
                klt_max_shift=cfg.klt_max_shift,
                klt_distinct_min=cfg.klt_distinct_min,
                wide_fov=cfg.camera_model == "kb8",
                use_klt=use_klt,
                n_rounds=n_rounds, move_obs=cfg.klt_move_obs,
                flow=flow, flow_radius=cfg.flow_anchor_radius,
                **stereo_kw,
            )
        uv_dev, uv_raw_dev = out[5][0], out[5][1]
        (R, t, kp_lm, inl, visible,
         (uv_new, uv_raw_new, ur_new, moved), n_flow) = jax.device_get(out)
        if flow is not None:
            self.stats["flow_anchor_matches"] = (
                self.stats.get("flow_anchor_matches", 0) + int(n_flow))
        frame.R_cw = np.array(R)
        frame.t_cw = np.array(t)
        frame.kp_lm = np.array(kp_lm)
        if moved.any():
            # The program returns the FULL updated arrays: install them as
            # the frame's host copies (no lazy-fetch trigger) and keep the
            # device handles resident instead of re-uploading next
            # dispatch.
            frame.fill_host(uv=np.array(uv_new), uv_raw=np.array(uv_raw_new))
            frame.set_dev("uv", uv_dev)
            frame.set_dev("uv_raw", uv_raw_dev)
            if frame.u_r is not None and ur_new is not None:
                frame.u_r[:] = ur_new
        return int(inl.sum()), visible

    def _track_local_map_fused(self, frame: Frame, cand) -> int:
        """Both local-map rounds through ONE dispatch of the fused program
        (pipeline/fused_round.py): a single upload + fetch for the whole
        match/verify/bind/solve x2 sequence."""
        cfg, m = self.cfg, self.map
        block, blk_mask, cand = self._build_lm_block(
            cand, cfg.local_map_size)
        n, visible = self._exec_fused_rounds(
            frame, block, blk_mask, frame.R_cw, frame.t_cw,
            th=1.0, level_slack=1, n_rounds=2)
        with m.lock:
            vis = visible[: cand.size]
            m.lm_visible[cand[vis]] += 1
            _, lms_after = frame.bound_obs()
            m.lm_found[lms_after] += 1
        return n

    def _fused_round_wide(self, frame: Frame, lm_ids, R_pred, t_pred,
                          th, with_flow=False) -> int:
        """Motion-model step as one fused round with wide gates; with
        ``with_flow`` the flow-anchor prologue runs inside the SAME
        dispatch (no separate match + KLT round trips)."""
        cfg, m = self.cfg, self.map
        block, blk_mask, cand = self._build_lm_block(
            lm_ids, 1024, wide_gates=True, R_pred=R_pred, t_pred=t_pred)
        flow = None
        lf = self.last_frame
        if with_flow and cfg.flow_anchor and lf is not None:
            with m.lock:
                bound = (lf.kp_lm != NO_LM) & lf.valid
                bound &= m.lm_valid[np.clip(lf.kp_lm, 0, m.max_lm - 1)]
                if bound.sum() >= 3:
                    row_of = np.full(m.max_lm, -1, np.int32)
                    row_of[cand] = np.arange(cand.size, dtype=np.int32)
                    gid = np.where(bound, lf.kp_lm, NO_LM).astype(np.int32)
                    cl = np.clip(gid, 0, m.max_lm - 1)
                    src_uv = lf.dev("uv")
                    src_desc = lf.dev("desc")
                    src_angle = lf.dev("angle")
                    src_bound = jnp.asarray(bound)
                    src_gid = jnp.asarray(gid)
                    src_row = row_of[cl]
                    # Retrieval-anchored channel (round-4 VERDICT #3): the
                    # REFERENCE KEYFRAME's original observations join the
                    # pose-free source set.  Their descriptors/templates
                    # are frozen at keyframe creation + BA, so this gives
                    # the per-frame association a drift-free anchor the
                    # pose-gated selection loop cannot bias — the role of
                    # SearchByProjection(frame, KF, ...)
                    # (/root/reference/include/ORBmatcher.h:55), matched
                    # image-side instead of through the (drifting) pose.
                    # Last-frame rows come first: first-wins keeps image
                    # continuity primary on contested keypoints.
                    if cfg.refkf_anchor and self.ref_kf >= 0:
                        rk = self.ref_kf
                        kb = (m.kf_kp_valid[rk]
                              & (m.kf_kp_lm[rk] != NO_LM))
                        kgid = np.where(kb, m.kf_kp_lm[rk],
                                        NO_LM).astype(np.int32)
                        kb &= m.lm_valid[np.clip(kgid, 0, m.max_lm - 1)]
                        kcl = np.clip(kgid, 0, m.max_lm - 1)
                        src_uv = jnp.concatenate(
                            [src_uv, jnp.asarray(m.kf_kp_uv[rk])])
                        src_desc = jnp.concatenate(
                            [src_desc, jnp.asarray(m.kf_desc[rk])])
                        src_angle = jnp.concatenate(
                            [src_angle, jnp.asarray(m.kf_kp_angle[rk])])
                        src_bound = jnp.concatenate(
                            [src_bound, jnp.asarray(kb)])
                        src_gid = jnp.concatenate(
                            [src_gid, jnp.asarray(kgid)])
                        src_row = np.concatenate([src_row, row_of[kcl]])
                    flow = (src_uv, src_desc, src_angle, src_bound,
                            src_gid, jnp.asarray(src_row))
        n, _ = self._exec_fused_rounds(frame, block, blk_mask,
                                       R_pred, t_pred, th=th, level_slack=7,
                                       flow=flow)
        return n

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame, n_inliers: int) -> bool:
        cfg, m = self.cfg, self.map
        frames_since = frame.frame_id - self.last_kf_frame_id
        # Reference-KF match count at min 3 observations (NeedNewKeyFrame's
        # nRefMatches).
        with m.lock:
            obs = m.landmark_obs_count()
            ref_lms = m.kf_kp_lm[self.ref_kf]
            ref_lms = ref_lms[ref_lms != NO_LM]
            min_obs = 3 if m.n_kf > 2 else 2
            n_ref = int((obs[ref_lms] >= min_obs).sum())
        c1a = frames_since >= cfg.fps  # mMaxFrames = fps
        c2 = (n_inliers < cfg.kf_ref_ratio * max(n_ref, 1)) and n_inliers > 15
        # With the background mapper busy, defer non-urgent keyframes (the
        # reference's bLocalMappingIdle gate, Tracking.cc:3097): only the
        # max-interval condition forces insertion.
        if (self.async_map is not None and self.async_map.busy
                and not c1a):
            return False
        return c1a or (frames_since >= cfg.kf_min_gap and c2)

    def _create_keyframe(self, frame: Frame):
        m = self.map
        with m.lock:
            kf = m.add_keyframe(
                frame.R_cw, frame.t_cw, frame.uv, frame.level, frame.angle,
                frame.valid, frame.desc, frame.frame_id, frame.timestamp,
                kp_lm=frame.kp_lm, patch=frame.patch, ur=frame.u_r,
            )
            self.ref_kf = kf
            frame.ref_kf = kf
            self.last_kf_frame_id = frame.frame_id
            self.stats["n_kf"] += 1
            kp, lms = frame.bound_obs()
            m.update_landmark_stats(lms)
        if self.async_map is not None:
            # Reference thread handoff (LocalMapping::InsertKeyFrame,
            # LocalMapping.cc:292-297): mapping + the loop cascade run on
            # the worker; tracking continues immediately.  Pose refinements
            # land in the map arrays and are picked up at the next map
            # read; loop/merge effects on tracker state arrive as events
            # (SlamSystem._drain_async_events).
            if self.local_mapper is not None:
                self.local_mapper.note_new_keyframe(kf)
                self.async_map.submit(functools.partial(
                    self._background_kf_task, self.local_mapper,
                    self.loop_closer, m, kf))
            return
        if self.local_mapper is not None:
            with self.timers.stage("mapping/keyframe"):
                self.local_mapper.note_new_keyframe(kf)
                self.local_mapper.run_once()
            # Mapping may have refined the pose of this keyframe; propagate.
            frame.R_cw = m.kf_R[kf].copy()
            frame.t_cw = m.kf_t[kf].copy()
        if self.loop_closer is not None:
            with self.timers.stage("loop/detect_correct"):
                loop_hit = self.loop_closer(kf)
            if loop_hit:
                # Loop corrected: poses moved; refresh the frame pose and
                # drop the velocity model (the reference aborts BA and
                # resumes from corrected poses).
                frame.R_cw = m.kf_R[kf].copy()
                frame.t_cw = m.kf_t[kf].copy()
                self.velocity = None

    def _background_kf_task(self, mapper, loop_cb, m, kf):
        """One keyframe's mapping + loop work, run on the worker thread."""
        with self.timers.stage("mapping/keyframe_bg"):
            mapper.run_once()
        if loop_cb is not None and m is self.map:
            # The cascade manages its own locking (detection / Sim3 solves
            # run lock-free; only map mutations take m.lock) so the
            # tracker is not stalled for the whole detection+GBA duration
            # (the reference likewise locks the map only for the
            # correction write-back, LoopClosing.cc:1041).
            with self.timers.stage("loop/detect_correct_bg"):
                hit = loop_cb(kf)
            if hit:
                self.async_map.post_event("loop", kf)

    # ------------------------------------------------------------------
    def _record_trajectory(self, frame: Frame):
        if frame.R_cw is None:
            return
        m = self.map
        ref = frame.ref_kf if frame.ref_kf >= 0 else self.ref_kf
        if ref >= 0:
            with m.lock:
                Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
            Ri, ti = _np_se3_inverse(np.asarray(Rr), np.asarray(tr))
            Rrel, trel = _np_se3_compose(
                np.asarray(frame.R_cw), np.asarray(frame.t_cw), Ri, ti)
            # Keep the frame's pose re-composable against its reference
            # keyframe (Tracking::UpdateLastFrame, Tracking.cc:2793-2810):
            # when mapping/loop BA moves the map, the next frame re-anchors
            # this relative pose on the refined keyframe pose instead of
            # measuring steps against a stale absolute pose.
            frame.rel_ref = int(ref)
            frame.rel_R = Rrel
            frame.rel_t = trel
            self.trajectory.append(
                (frame.timestamp, ref, Rrel, trel,
                 self.state, frame.pose_ok, self.map)
            )

    def final_trajectory(self, with_map_ids=False):
        """Replay relative poses against (possibly BA-corrected) keyframe
        poses (System::SaveTrajectoryEuRoC semantics).  Returns (T, 8):
        timestamp + T_wc position + quaternion [qw qx qy qz]; with
        ``with_map_ids`` also the owning map id per row (rows from
        different maps have independent gauges — align them separately)."""
        from orb_slam3_study_kr_tpu.lie.so3 import matrix_to_quat

        rows, map_ids = [], []
        for ts, ref, Rrel, trel, state, ok, m in self.trajectory:
            if not ok:
                continue
            # Culled reference keyframes redirect to a live ancestor
            # (the reference climbs the spanning tree over bad keyframes
            # composing KeyFrame::mTcp, System.cc:595-627).
            with m.lock:
                ref, Rrel, trel = m.resolve_kf(int(ref), Rrel, trel)
                if ref < 0:
                    continue
                Rr, tr = m.kf_R[ref].copy(), m.kf_t[ref].copy()
            R_cw, t_cw = se3.se3_compose(
                jnp.asarray(Rrel), jnp.asarray(trel),
                jnp.asarray(Rr), jnp.asarray(tr),
            )
            R_wc, t_wc = se3.se3_inverse(R_cw, t_cw)
            q = np.asarray(matrix_to_quat(R_wc))
            rows.append([ts, *np.asarray(t_wc), q[0], q[1], q[2], q[3]])
            map_ids.append(m.map_id)
        rows = np.array(rows)
        if with_map_ids:
            return rows, np.array(map_ids, np.int64)
        return rows

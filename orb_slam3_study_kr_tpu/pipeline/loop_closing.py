"""Loop detection and correction (replaces src/LoopClosing.cc, visual path).

The reference's full verification cascade (LoopClosing.cc:325-820) is
reproduced stage for stage:

  1. BoW candidate retrieval (KeyFrameDatabase::DetectNBestCandidates).
  2. Descriptor matching between landmark-bound keypoints >= nBoWMatches=20
     (LoopClosing.cc:583).
  3. Sim3 RANSAC >= nBoWInliers=15 (LoopClosing.cc:584,699-711).
  4. Guided SearchByProjection of the candidate's covisible-window landmarks
     through the coarse Sim3 >= nProjMatches=50 (LoopClosing.cc:586,756).
  5. OptimizeSim3 reprojection GN refinement (Optimizer.cc:2118), then a
     second guided projection with the refined Sim3 >= nProjOptMatches=80
     (LoopClosing.cc:587,775-795).
  6. Temporal consistency: the same region must verify in >= 3 consecutive
     keyframes, each time by propagating the previous Sim3 through the
     relative odometry and re-running stages 4-5
     (NewDetectCommonRegions / DetectAndReffineSim3FromLastKF,
     LoopClosing.cc:376-466,537-578).

On acceptance the loop is corrected (CorrectLoop, LoopClosing.cc:971-1216):
essential-graph Sim3/4-DoF pose solve (with all previously accepted loop
edges retained), landmark re-expression through each point's reference
keyframe, loop-point SearchAndFuse duplicate welding (LoopClosing.cc:1142),
and a global BA refinement.
"""

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_study_kr_tpu.bow.database import KeyframeDatabase
from orb_slam3_study_kr_tpu.ops.track_match import (match_by_descriptor,
                                                    match_local_map)
from orb_slam3_study_kr_tpu.slam_map.map_state import NO_LM, MapState
from orb_slam3_study_kr_tpu.solvers.pose_graph import (optimize_pose_graph,
                                                       relative_sim3)
from orb_slam3_study_kr_tpu.solvers.sim3_solver import (optimize_sim3,
                                                        ransac_sim3)

MIN_MAP_KFS = 12        # reference skips loop detection below 12 KFs
COVIS_EDGE_WEIGHT = 100
MAX_WINDOW_LMS = 4096   # padded landmark count for the guided projections


def _pad(a, n, fill=0):
    out = np.full((n, *a.shape[1:]), fill, a.dtype)
    out[: min(len(a), n)] = a[:n]
    return out


@dataclass
class LoopCloser:
    cfg: "TrackerConfig"
    map: MapState
    db: KeyframeDatabase
    inertial: bool = False
    run_gba: bool = True    # full-map BA after the pose-graph correction
    gba_iters: int = 10     # LoopClosing.cc:2289 nIterations=10
    ba_mesh: object = None  # jax.sharding.Mesh -> landmark-sharded GBA
    # Cascade gates (reference values, LoopClosing.cc:583-587).  Synthetic
    # tests with sparse scenes may lower them proportionally.
    min_bow_matches: int = 20       # nBoWMatches
    min_ransac_inliers: int = 15    # nBoWInliers
    min_proj_matches: int = 50      # nProjMatches
    min_proj_opt_matches: int = 80  # nProjOptMatches
    consistency_required: int = 3   # consecutive-KF verifications
    max_not_found: int = 2          # pending dropped after this many misses
    stats: dict = field(default_factory=lambda: {
        "n_queries": 0, "n_candidates": 0, "n_stage_bow": 0,
        "n_stage_ransac": 0, "n_stage_proj": 0, "n_verified": 0,
        "n_pending": 0, "n_rejected_temporal": 0, "n_corrected": 0,
        "n_fused_loop": 0, "n_gba": 0})
    loop_edges: list = field(default_factory=list)  # accepted (kf, cand, R, t, s)
    _pending: dict = None   # candidate awaiting temporal consistency
    _key: object = None

    def __post_init__(self):
        if self._key is None:
            self._key = jax.random.PRNGKey(17)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int):
        """Run the detection cascade for one new keyframe; correct the loop
        once temporal consistency is reached.  Returns True on correction.

        Locking: detection and the Sim3 verification solves run WITHOUT
        the map lock (host reads take it briefly; device fetches wait
        outside it), so the tracker thread is never stalled behind the
        cascade.  Only the correction write-back (`_accept`) mutates the
        map under the lock — the reference's thread split, which also
        only takes mMutexMapUpdate inside CorrectLoop."""
        m = self.map
        corrected = False
        with m.lock:
            big_enough = m.n_kf >= MIN_MAP_KFS
        if big_enough:
            self.stats["n_queries"] += 1
            if self._pending is not None:
                corrected = self._advance_pending(kf)
            if not corrected and self._pending is None:
                for cand in self._detect(kf):
                    self.stats["n_candidates"] += 1
                    hit = self._verify_cascade(kf, cand)
                    if hit is not None:
                        self.stats["n_verified"] += 1
                        self._pending = dict(
                            cand=cand, window=hit["window"],
                            Scw=hit["Scw"], last_kf=kf, count=1, not_found=0)
                        self.stats["n_pending"] += 1
                        if self.consistency_required <= 1:
                            corrected = self._accept(kf)
                        break
        with m.lock:
            self.db.add(kf, m.kf_desc[kf, : m.max_kp], m.kf_kp_valid[kf])
        return corrected

    # ------------------------------------------------------------------
    def _detect(self, kf: int):
        m = self.map
        with m.lock:
            covis, _ = m.covisibility(kf, min_shared=5)
            exclude = set(covis.tolist()) | {kf}
            return self.db.detect_candidates(
                m.kf_desc[kf], m.kf_kp_valid[kf],
                exclude=exclude,
                covisibility=lambda k: m.covisibility(k, min_shared=15)[0][:5],
                n_best=3,
            )

    # ------------------------------------------------------------------
    def _window_landmarks(self, cand: int):
        """Landmarks of the candidate and its 10 best covisible neighbors
        (LoopClosing.cc:613 nNumCovisibles)."""
        m = self.map
        with m.lock:
            nbs, _ = m.covisibility(cand, min_shared=15)
            kfs = [cand] + [int(k) for k in nbs[:10]]
            lms = np.unique(m.kf_kp_lm[kfs])
            lms = lms[lms != NO_LM]
            return lms[m.lm_valid[lms]], kfs

    # ------------------------------------------------------------------
    def _guided_match(self, kf: int, lms: np.ndarray, R_s, t_s, s_s, th=3.0):
        """SearchByProjection(KeyFrame, Scw, points) — project window
        landmarks through the scaled world->camera Sim3 into the keyframe.
        The Sim3 is normalized to [R | t/s] so camera-frame distances stay in
        map units (ORBmatcher.cc SearchByProjection Scw normalization).

        Host reads + dispatch run under the map lock; the device fetch
        waits outside it so the tracker interleaves.

        Returns (kp_idx, lm_ids) of accepted pairs."""
        m = self.map
        n = min(lms.size, MAX_WINDOW_LMS)
        lms = lms[:n]
        mask = np.zeros(MAX_WINDOW_LMS, np.float32)
        mask[:n] = 1.0
        with m.lock:
            out = match_local_map(
                self.cfg.project_fn,
                jnp.asarray(R_s, jnp.float32),
                jnp.asarray(np.asarray(t_s, np.float32) / np.float32(s_s)),
                jnp.asarray(_pad(m.lm_pos[lms], MAX_WINDOW_LMS)),
                jnp.asarray(_pad(m.lm_normal[lms], MAX_WINDOW_LMS)),
                jnp.asarray(_pad(m.lm_min_dist[lms], MAX_WINDOW_LMS)),
                jnp.asarray(_pad(m.lm_max_dist[lms], MAX_WINDOW_LMS)),
                jnp.asarray(_pad(m.lm_desc[lms], MAX_WINDOW_LMS)),
                jnp.asarray(mask),
                jnp.asarray(m.kf_kp_uv[kf]), jnp.asarray(m.kf_kp_level[kf]),
                jnp.asarray(m.kf_desc[kf]), jnp.asarray(m.kf_kp_valid[kf]),
                self.cfg.width, self.cfg.height, th=th, max_dist=50.0,
                max_theta_deg=self.cfg.max_theta_deg,
            )
        lm_slot, ok = jax.device_get(out[:2])
        ok = ok & (lm_slot < n)
        kp_idx = np.nonzero(ok)[0]
        return kp_idx, lms[lm_slot[kp_idx]]

    # ------------------------------------------------------------------
    def _refine_sim3(self, kf: int, cand: int, kp_idx, lm_ids,
                     R12, t12, s12):
        """OptimizeSim3 on the guided matches: two-sided reprojection GN over
        S12 (candidate camera -> current camera).  Pairs need the current
        keypoint's own landmark for the inverse edge (Optimizer.cc:2170-2190);
        unbound keypoints are dropped from the solve."""
        m = self.map
        with m.lock:
            lm1 = m.kf_kp_lm[kf, kp_idx]
            keep = (lm1 != NO_LM) & m.lm_valid[np.clip(lm1, 0, None)]
            kp_idx, lm_ids, lm1 = kp_idx[keep], lm_ids[keep], lm1[keep]
            if kp_idx.size < 3:
                return None
            P1 = m.lm_pos[lm1] @ m.kf_R[kf].T + m.kf_t[kf]
            P2 = m.lm_pos[lm_ids] @ m.kf_R[cand].T + m.kf_t[cand]
            uv1 = m.kf_kp_uv[kf, kp_idx]
            N = 256
            mask = _pad(np.ones(kp_idx.size, np.float32), N)
            out = optimize_sim3(
                jnp.asarray(_pad(P1.astype(np.float32), N)),
                jnp.asarray(_pad(P2.astype(np.float32), N)),
                jnp.asarray(mask),
                jnp.asarray(_pad(uv1.astype(np.float32), N)),
                self.cfg.project_fn(jnp.asarray(_pad(P2.astype(np.float32),
                                                     N))),
                self.cfg.K,
                jnp.asarray(R12, jnp.float32), jnp.asarray(t12, jnp.float32),
                jnp.asarray(s12, jnp.float32), fix_scale=self.inertial,
                project_fn=self.cfg.project_fn,
            )
        R12_f, t12_f, s12_f = jax.device_get(
            (out["R12"], out["t12"], out["s12"]))
        return np.asarray(R12_f), np.asarray(t12_f), float(s12_f)

    # ------------------------------------------------------------------
    @staticmethod
    def _compose_scw(R12, t12, s12, R_c, t_c):
        """Scw = S12 . T_cand_w  (world -> current camera, scaled)."""
        R = R12 @ R_c
        t = s12 * R12 @ t_c + t12
        return R, t, s12

    @staticmethod
    def _s12_from_scw(R_s, t_s, s_s, R_c, t_c):
        """S12 = Scw . T_w_cand  (candidate camera -> current camera)."""
        R12 = R_s @ R_c.T
        t12 = t_s - s_s * R12 @ t_c
        return R12, t12, s_s

    # ------------------------------------------------------------------
    def _bow_window_match(self, kf: int, cand: int):
        """Stage-2 descriptor matching of the current keyframe against the
        candidate AND its 10 best covisible neighbors, accumulated per
        current keypoint (DetectCommonRegionsFromBoW walks vpCovKFi and
        sums the SearchByBoW matches before the >= nBoWMatches gate,
        LoopClosing.cc:620-692).  One batched dispatch for the whole
        window; per keypoint the lowest-distance window hit wins.

        Returns (kp1, lm2, win_kfs): matched current keypoints, the
        window landmark each matched, and the window keyframes."""
        m = self.map
        with m.lock:
            nbs, _ = m.covisibility(cand, min_shared=15)
            win_kfs = [cand] + [int(k) for k in nbs[:10]]
            # bAbortByNearKF (LoopClosing.cc:630-643): if ANY window
            # keyframe is covisibility-connected to the current keyframe,
            # the "loop" is just spatial adjacency in a consistent map —
            # abort the candidate.
            connected, _ = m.covisibility(kf, min_shared=15)
            if np.isin(win_kfs, connected).any():
                return np.empty(0, np.int64), np.empty(0, np.int32), win_kfs
            W = len(win_kfs)
            q_desc = jnp.asarray(m.kf_desc[kf])
            b1 = m.kf_kp_lm[kf] != NO_LM
            q_valid = jnp.asarray(m.kf_kp_valid[kf] & b1)
            t_desc = jnp.asarray(m.kf_desc[win_kfs])
            t_bound = m.kf_kp_lm[win_kfs] != NO_LM
            t_valid = jnp.asarray(m.kf_kp_valid[win_kfs] & t_bound)
            idx, ok, best = jax.vmap(
                lambda td, tv: match_by_descriptor(q_desc, q_valid, td, tv)
            )(t_desc, t_valid)
        idx, ok, best = jax.device_get((idx, ok, best))
        best = np.where(ok, best, np.inf)           # (W, N)
        wsel = np.argmin(best, axis=0)              # best window KF per kp
        n = idx.shape[1]
        any_ok = np.isfinite(best[wsel, np.arange(n)])
        with m.lock:
            lm2 = np.full(n, NO_LM, np.int32)
            for w in range(W):
                rows = np.nonzero(any_ok & (wsel == w))[0]
                lm2[rows] = m.kf_kp_lm[win_kfs[w], idx[w, rows]]
            good = (lm2 != NO_LM) & m.lm_valid[np.clip(lm2, 0, None)]
        kp1 = np.nonzero(good)[0]
        return kp1, lm2[kp1], win_kfs

    # ------------------------------------------------------------------
    def _verify_cascade(self, kf: int, cand: int):
        """Stages 2-5 for a fresh candidate.  Returns dict(Scw, window) or
        None."""
        m = self.map
        # Stage 2: window-aggregated descriptor matches (candidate + 10
        # covisibles) between landmark-bound keypoints.
        kp1, lm2, _ = self._bow_window_match(kf, cand)
        if kp1.size < self.min_bow_matches:
            return None
        self.stats["n_stage_bow"] += 1
        N = 256
        self._key, sub = jax.random.split(self._key)
        with m.lock:
            lm1 = m.kf_kp_lm[kf, kp1]
            P1 = m.lm_pos[lm1] @ m.kf_R[kf].T + m.kf_t[kf]
            P2 = m.lm_pos[lm2] @ m.kf_R[cand].T + m.kf_t[cand]
            uv1 = m.kf_kp_uv[kf, kp1]
            uv2 = np.asarray(jax.device_get(self.cfg.project_fn(
                jnp.asarray(P2.astype(np.float32)))), np.float32)
            mask = _pad(np.ones(len(kp1), np.float32), N)
            # Stage 3: Sim3 RANSAC on the camera-frame landmark pairs.
            out = ransac_sim3(
                sub, jnp.asarray(_pad(P1, N)), jnp.asarray(_pad(P2, N)),
                jnp.asarray(mask), jnp.asarray(_pad(uv1, N)),
                jnp.asarray(_pad(uv2, N)),
                self.cfg.K, fix_scale=self.inertial,
                project_fn=self.cfg.project_fn,
            )
        n_inl, R12, t12, s12 = jax.device_get(
            (out["n_inliers"], out["R12"], out["t12"], out["s12"]))
        if int(n_inl) < self.min_ransac_inliers:
            return None
        self.stats["n_stage_ransac"] += 1
        R12, t12, s12 = np.asarray(R12), np.asarray(t12), float(s12)
        # Stage 4: guided projection of the candidate window's landmarks.
        window, _ = self._window_landmarks(cand)
        with m.lock:
            R_c, t_c = m.kf_R[cand].copy(), m.kf_t[cand].copy()
        Scw = self._compose_scw(R12, t12, s12, R_c, t_c)
        kp_idx, lm_ids = self._guided_match(kf, window, *Scw, th=3.0)
        if kp_idx.size < self.min_proj_matches:
            return None
        self.stats["n_stage_proj"] += 1
        # Stage 5: OptimizeSim3 refinement + re-projection gate.
        ref = self._refine_sim3(kf, cand, kp_idx, lm_ids, R12, t12, s12)
        if ref is None:
            return None
        Scw = self._compose_scw(*ref, R_c, t_c)
        kp_idx, lm_ids = self._guided_match(kf, window, *Scw, th=1.5)
        if kp_idx.size < self.min_proj_opt_matches:
            return None
        return dict(Scw=Scw, window=window)

    # ------------------------------------------------------------------
    def _advance_pending(self, kf: int):
        """DetectAndReffineSim3FromLastKF: propagate the pending Sim3 through
        relative odometry to this keyframe and re-verify stages 4-5; accept
        the loop once `consistency_required` consecutive KFs confirmed."""
        m = self.map
        p = self._pending
        last = p["last_kf"]
        cand = p["cand"]
        with m.lock:
            # T_cur_last from the current pose estimates;
            # Scw_cur = T_cur_last . Scw_last.
            R_cl = m.kf_R[kf] @ m.kf_R[last].T
            t_cl = m.kf_t[kf] - R_cl @ m.kf_t[last]
            R_c, t_c = m.kf_R[cand].copy(), m.kf_t[cand].copy()
        R_s, t_s, s_s = p["Scw"]
        Scw = (R_cl @ R_s, R_cl @ t_s + s_s * t_cl, s_s)
        kp_idx, lm_ids = self._guided_match(kf, p["window"], *Scw, th=3.0)
        ok = kp_idx.size >= self.min_proj_matches
        if ok:
            S12 = self._s12_from_scw(*Scw, R_c, t_c)
            ref = self._refine_sim3(kf, cand, kp_idx, lm_ids, *S12)
            if ref is not None:
                Scw_ref = self._compose_scw(*ref, R_c, t_c)
                kp_idx, _ = self._guided_match(kf, p["window"], *Scw_ref,
                                               th=1.5)
                if kp_idx.size >= self.min_proj_opt_matches:
                    p.update(Scw=Scw_ref, last_kf=kf, not_found=0)
                    p["count"] += 1
                    if p["count"] >= self.consistency_required:
                        return self._accept(kf)
                    return False
        p["not_found"] += 1
        if p["not_found"] >= self.max_not_found:
            self.stats["n_rejected_temporal"] += 1
            self._pending = None
        return False

    # ------------------------------------------------------------------
    def _accept(self, kf: int):
        m = self.map
        p = self._pending
        self._pending = None
        cand = p["cand"]
        # Mutation phase: essential-graph correction + loop-point fusion
        # hold the lock; the GBA afterwards snapshots under the lock,
        # solves lock-free and re-acquires only for the write-back.
        with m.lock:
            R12, t12, s12 = self._s12_from_scw(*p["Scw"], m.kf_R[cand],
                                               m.kf_t[cand])
            self._correct(kf, cand, dict(R12=R12, t12=t12, s12=s12))
            self._search_and_fuse(kf, p["window"])
        self.stats["n_corrected"] += 1
        self._run_gba()
        return True

    # ------------------------------------------------------------------
    def _correct(self, kf: int, cand: int, sim3):
        """Essential-graph correction: the loop edge constrains
        S_kf = S12 . S_cand (S maps world -> camera, Sim3 with the
        estimated scale).  All previously accepted loop edges participate
        (KeyFrame loop-edge bookkeeping, KeyFrame.h:242-247)."""
        m = self.map
        kfs = np.nonzero(m.kf_valid)[0]
        K = kfs.size
        pos = {int(k): i for i, k in enumerate(kfs)}

        # Record old poses for landmark correction.
        R_old = m.kf_R[kfs].copy()
        t_old = m.kf_t[kfs].copy()

        # Assemble edges as INDEX PAIRS on the host; every measured
        # relative Sim3 is then computed in ONE batched program (the old
        # per-edge relative_sim3 calls were O(E) tiny dispatches — seconds
        # of host work per correction at scale, VERDICT round 4).
        ei, ej, w = [], [], []

        def add_edge(i, j, weight=1.0):
            ei.append(pos[i]); ej.append(pos[j]); w.append(weight)

        # Covisibility spanning tree (KeyFrame::ChangeParent semantics,
        # KeyFrame.h:233-240): each keyframe's parent is the earlier
        # keyframe it shares most observations with, falling back to the
        # temporal predecessor when nothing covisible precedes it.
        order = {int(k): i for i, k in enumerate(kfs)}
        for a in kfs[1:]:
            a = int(a)
            nb, wts = m.covisibility(a, min_shared=1)
            parent, best_w = None, 0
            for j, wj in zip(nb, wts):
                if order[int(j)] < order[a] and wj > best_w:
                    parent, best_w = int(j), int(wj)
            if parent is None:
                parent = int(kfs[order[a] - 1])
            add_edge(a, parent)
        # Strong covisibility edges.
        for i in kfs:
            nb, wts = m.covisibility(int(i), min_shared=COVIS_EDGE_WEIGHT)
            for j, _ in zip(nb[:5], wts):
                if int(j) > int(i) + 1:
                    add_edge(int(i), int(j))
        # Previously accepted loop edges: their relative Sim3 was burned into
        # the poses at their own correction, so re-measure from poses.
        for (a, b) in self.loop_edges:
            if a in pos and b in pos:
                add_edge(a, b, weight=5.0)
        self.loop_edges.append((int(kf), int(cand)))

        # Pad vertices/edges to buckets so repeated corrections reuse one
        # compiled program per bucket (padded vertices are fixed identity;
        # padded edges carry weight 0).
        Kp = max(16, -(-K // 16) * 16)
        E = len(ei) + 1                       # + the measured loop edge
        Ep = max(64, -(-E // 64) * 64)
        R_p = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        t_p = np.zeros((Kp, 3), np.float32)
        R_p[:K] = m.kf_R[kfs]
        t_p[:K] = m.kf_t[kfs]
        ei_p = np.zeros(Ep, np.int32)
        ej_p = np.zeros(Ep, np.int32)
        w_p = np.zeros(Ep, np.float32)
        ei_p[: E - 1] = ei
        ej_p[: E - 1] = ej
        w_p[: E - 1] = w
        R_dev = jnp.asarray(R_p)
        t_dev = jnp.asarray(t_p)
        s_dev = jnp.ones(Kp)

        # Measured relative Sim3 of every non-loop edge, in one program.
        Rm, tm, sm = jax.vmap(relative_sim3, in_axes=(0, 0, 0, 0, 0, 0))(
            R_dev[ei_p], t_dev[ei_p], s_dev[ei_p],
            R_dev[ej_p], t_dev[ej_p], s_dev[ej_p])
        # The new loop edge: S_kf_corrected = S12 . S_cand  =>  relative
        # S_kf . S_cand^-1 measured as S12.
        le = E - 1
        ei_p[le] = pos[kf]
        ej_p[le] = pos[cand]
        w_p[le] = 5.0
        Rm = Rm.at[le].set(jnp.asarray(np.asarray(sim3["R12"], np.float32)))
        tm = tm.at[le].set(jnp.asarray(np.asarray(sim3["t12"], np.float32)))
        sm = sm.at[le].set(jnp.float32(sim3["s12"]))

        fixed = np.ones(Kp, np.float32)
        fixed[1:K] = 0.0                      # origin keyframe anchors
        dof = 4 if self.inertial else 7
        R_f, t_f, s_f = optimize_pose_graph(
            R_dev, t_dev, s_dev,
            jnp.asarray(ei_p), jnp.asarray(ej_p),
            Rm, tm, sm,
            jnp.asarray(w_p), jnp.asarray(fixed),
            n_iters=20, dof=dof,
        )
        R_f, t_f, s_f = jax.device_get((R_f, t_f, s_f))
        R_f = np.asarray(R_f)[:K]
        t_f = np.asarray(t_f)[:K]
        s_f = np.asarray(s_f)[:K]

        # Apply: scaled-rigid per keyframe (divide translation by scale to
        # keep SE3 poses, the reference's [R | t/s] normalization).
        m.kf_R[kfs] = R_f
        m.kf_t[kfs] = t_f / s_f[:, None]

        # Landmarks: re-express through the keyframe that first observed
        # them (CorrectLoop's reference-KF correction).
        lms = np.nonzero(m.lm_valid)[0]
        if lms.size:
            ref_kf = m.lm_first_kf[lms]
            ref_kf = np.clip(ref_kf, 0, m.max_kf - 1)
            ref_idx = np.array([pos.get(int(k), 0) for k in ref_kf])
            Ro = R_old[ref_idx]
            to = t_old[ref_idx]
            Rn = R_f[ref_idx]
            tn = t_f[ref_idx]
            sn = s_f[ref_idx]
            # X_new = S_new^-1( S_old(X) ): push through the old SE3, pull
            # back through the corrected Sim3 (CorrectLoop's
            # correctedSwc.map(Siw.map(P3Dw))).
            pc = np.einsum("nij,nj->ni", Ro, m.lm_pos[lms]) + to
            m.lm_pos[lms] = np.einsum(
                "nji,nj->ni", Rn, pc - tn) / sn[:, None]
        m.change_idx += 1

    # ------------------------------------------------------------------
    def _search_and_fuse(self, kf: int, window_lms: np.ndarray):
        """Loop-point fusion (LoopClosing::SearchAndFuse, LoopClosing.cc:
        1142,2120): project the loop side's landmarks into the current
        keyframe and its covisible neighbors (poses already corrected);
        duplicates are welded in favor of the loop-side landmark."""
        from orb_slam3_study_kr_tpu import native

        m = self.map
        nbs, _ = m.covisibility(kf, min_shared=15)
        targets = [kf] + [int(k) for k in nbs[:10]]
        window_lms = window_lms[m.lm_valid[window_lms]]
        if window_lms.size == 0:
            return
        for t_kf in targets:
            kp_idx, lm_ids = self._guided_match(
                kf=t_kf, lms=window_lms,
                R_s=m.kf_R[t_kf], t_s=m.kf_t[t_kf], s_s=1.0, th=4.0)
            for kp, lm_new in zip(kp_idx, lm_ids):
                lm_old = int(m.kf_kp_lm[t_kf, kp])
                lm_new = int(lm_new)
                if lm_old == lm_new or not m.lm_valid[lm_new]:
                    continue
                if lm_old == NO_LM:
                    m.kf_kp_lm[t_kf, kp] = lm_new
                    self.stats["n_fused_loop"] += 1
                elif m.lm_valid[lm_old]:
                    # The loop-side landmark replaces the current one
                    # everywhere (MapPoint::Replace from SearchAndFuse).
                    native.replace_landmark(m.kf_kp_lm, lm_old, lm_new)
                    m.lm_valid[lm_old] = False
                    self.stats["n_fused_loop"] += 1
        m.n_lm = int(m.lm_valid.sum())
        m.update_landmark_stats(window_lms)
        m.change_idx += 1

    # ------------------------------------------------------------------
    def _run_gba(self):
        """Global BA refines the pose-graph solution over the whole map
        (RunGlobalBundleAdjustment, LoopClosing.cc:2273)."""
        if self.run_gba:
            from orb_slam3_study_kr_tpu.pipeline.global_ba import (
                global_bundle_adjustment)
            if global_bundle_adjustment(self.cfg, self.map,
                                        n_iters=self.gba_iters,
                                        mesh=self.ba_mesh, use_lock=True):
                self.stats["n_gba"] += 1

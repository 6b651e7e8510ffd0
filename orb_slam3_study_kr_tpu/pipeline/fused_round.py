"""Fused track-local-map rounds: match + KLT verify + bind + pose-opt —
N complete rounds in ONE jitted program.

The split pipeline pays a host sync after each stage; a tracking frame
runs 2-3 rounds of (projection match -> photometric verify -> pose GN),
i.e. ~9 sync boundaries.  This program keeps the WHOLE round sequence on
device: the only host exchange is one argument upload batch and one
fetched result cluster for all rounds together.  Between rounds the program applies the
same host-side bookkeeping the split path does:

- landmarks bound in an earlier round leave the candidate block (the
  split path's ``blk_mask *= ~isin(cand, bound_now)``), and
- KLT-verified distinctive observation moves are written into the frame
  coordinates so they benefit the next round's matching/solve (the split
  path's klt_move_obs application between rounds).

Semantics match tracking.MonoTracker's split path
(_match_against_landmarks + _klt_refine_matches + _optimize_frame_pose)
with one deliberate difference: a moved observation benefits the NEXT
round instead of the same round's solve (sub-pixel lag, measured
neutral), and the stored-patch refresh stays off (the template keeps its
detection appearance; the KLT verifier tolerates the <= max_shift
offset).
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.ops import matching, track_match
from orb_slam3_study_kr_tpu.ops.klt import klt_refine
from orb_slam3_study_kr_tpu.slam_map.map_state import NO_LM
from orb_slam3_study_kr_tpu.solvers.pose_opt import optimize_pose


_BIG = jnp.int32(1 << 30)


def _flow_prologue(flow, blk_pos, blk_patch, kp_lm, kp_lm_pos, lm_mask,
                   f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
                   pyr, level_wh, use_klt,
                   klt_zncc_min, klt_max_shift, flow_radius):
    """In-program flow anchor (tracking._flow_anchor_matches semantics):
    pose-free windowed descriptor match of the LAST frame's bound features
    against the current frame, first-wins on contested keypoints, KLT
    photometric verification, then bind.  Returns updated
    (kp_lm, kp_lm_pos, lm_mask, klt outputs for the move write-back).

    The last frame's landmark positions/templates are NOT uploaded: the
    flow tuple carries each bound feature's ROW in the candidate block
    (host-side row_of table) and the position/patch are gathered from the
    block on device — bindings between block rebuilds are always block
    members, so the row lookup is total (rows < 0 are masked out)."""
    (lf_uv, lf_desc, lf_angle, lf_bound, lf_gid, lf_row) = flow
    lf_bound = lf_bound & (lf_row >= 0)
    row_cl = jnp.clip(lf_row, 0, blk_pos.shape[0] - 1)
    lf_pos = blk_pos[row_cl]
    lf_tmpl = blk_patch[row_cl]
    idx, ok, _ = matching.search_for_initialization(
        lf_uv, lf_desc, lf_angle, lf_bound,
        f_uv, f_desc, f_angle, f_valid,
        window_radius=flow_radius, nn_ratio=0.8,
    )
    n1 = lf_uv.shape[0]
    n2 = f_uv.shape[0]
    # First-wins on contested current keypoints: the smallest last-frame
    # index j claiming keypoint k wins (the split path's np.unique order).
    j_of = jnp.where(ok & lf_bound, jnp.arange(n1, dtype=jnp.int32), _BIG)
    minj = jnp.full(n2, _BIG, jnp.int32).at[idx].min(j_of)
    has = minj < _BIG
    src = jnp.clip(minj, 0, n1 - 1)
    cand_gid = jnp.where(has, lf_gid[src], NO_LM)
    cand_pos = lf_pos[src]
    cand_tmpl = lf_tmpl[src]
    mask = (cand_gid != NO_LM) & (kp_lm == NO_LM)
    if use_klt:
        uv_ref, zncc, shift, _win, distinct = klt_refine(
            pyr, level_wh, f_uv_raw, f_level, f_angle, cand_tmpl, mask,
            max_shift=klt_max_shift)
        good = mask & (zncc >= klt_zncc_min) & (shift < klt_max_shift)
    else:
        uv_ref = f_uv_raw
        distinct = jnp.full((n2,), -1.0, jnp.float32)
        good = mask
    kp_lm = jnp.where(good, cand_gid, kp_lm).astype(kp_lm.dtype)
    kp_lm_pos = jnp.where(good[:, None], cand_pos, kp_lm_pos)
    # Flow-bound landmarks leave the candidate block (the split path's
    # ``lm_ids[~isin(lm_ids, bound_now)]``).  Rows are looked up via the
    # host-built gid->row table; landmarks not in the block map to the
    # overflow slot.
    L = lm_mask.shape[0]
    row = jnp.where(good, lf_row[src], L)
    row = jnp.where(row < 0, L, row)
    taken = jnp.zeros(L + 1, lm_mask.dtype).at[row].max(
        good.astype(lm_mask.dtype))[:L]
    lm_mask = lm_mask * (1.0 - taken)
    return kp_lm, kp_lm_pos, lm_mask, (uv_ref, distinct, good), good


def _round(project_fn, project_jac_fn, R, t,
           lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
           lm_gid, lm_patch,
           kp_lm, kp_lm_pos,
           f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
           pyr, level_wh, width, height,
           th, nn_ratio, scale_factor, n_levels, level_slack,
           max_theta_deg, klt_zncc_min, klt_max_shift, klt_distinct_min,
           wide_fov, use_klt, move_obs, ur, bf, undistort_fn,
           apply_gate=None, kp_w=None, ambig_w=None):
    """One complete match -> KLT verify -> bind -> pose-GN round.  With
    ``apply_gate`` (a traced bool) the round's EFFECTS (bindings, pose,
    moves, mask consumption) only apply where the gate is True — the
    in-program form of the split path's 'retry with a wider window only
    if the first pass found too few matches'.

    ``kp_w`` (N,) carries a per-observation confidence weight into the
    pose solve; with ``ambig_w`` < 1 newly bound matches whose KLT
    alignment is NOT distinctive (alias-ambiguous on self-similar
    texture) enter at that reduced weight — they still anchor the solve
    but can no longer outvote the distinctive set into an aliased basin."""
    lm_slot, ok, visible = track_match.match_local_map(
        project_fn, R, t,
        lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
        f_uv, f_level, f_desc, f_valid,
        width, height, th=th, nn_ratio=nn_ratio,
        scale_factor=scale_factor,
        n_levels=n_levels, level_slack=level_slack,
        max_theta_deg=max_theta_deg,
    )
    gate = jnp.bool_(True) if apply_gate is None else apply_gate
    free = kp_lm == NO_LM
    cand_ok = ok & free & gate

    tmpl = lm_patch[lm_slot]
    if use_klt:
        uv_ref, zncc, shift, _win, distinct = klt_refine(
            pyr, level_wh, f_uv_raw, f_level, f_angle, tmpl, cand_ok,
            max_shift=klt_max_shift)
        good = cand_ok & (zncc >= klt_zncc_min) & (shift < klt_max_shift)
    else:
        uv_ref = f_uv_raw
        distinct = jnp.full((f_uv.shape[0],), -1.0, jnp.float32)
        good = cand_ok

    new_gid = lm_gid[lm_slot]
    kp_lm_new = jnp.where(good, new_gid, kp_lm)
    X = jnp.where(good[:, None], lm_pos[lm_slot], kp_lm_pos)
    bound = (kp_lm_new != NO_LM) & f_valid
    if kp_w is None:
        kp_w = jnp.ones(f_uv.shape[0], jnp.float32)
    if use_klt and ambig_w is not None:
        w_new = jnp.where(distinct >= klt_distinct_min, 1.0, ambig_w)
        kp_w = jnp.where(good & gate, w_new, kp_w)
    stereo_kw = {}
    if ur is not None:
        stereo_kw = dict(ur_obs=ur, bf=bf)
    R_new, t_new, inl, _ = optimize_pose(
        project_fn, project_jac_fn, R, t, X, f_uv, f_level,
        bound.astype(jnp.float32) * kp_w, wide_fov=wide_fov, **stereo_kw)
    R = jnp.where(gate, R_new, R)
    t = jnp.where(gate, t_new, t)
    inl = inl & bound
    kp_lm = jnp.where(gate, jnp.where(inl, kp_lm_new, NO_LM), kp_lm
                      ).astype(kp_lm.dtype)
    kp_lm_pos = jnp.where(gate, X, kp_lm_pos)

    taken = jnp.zeros(lm_mask.shape[0], lm_mask.dtype).at[lm_slot].max(
        (good & inl).astype(lm_mask.dtype))
    lm_mask = lm_mask * (1.0 - taken)

    moved = jnp.zeros(f_uv.shape[0], bool)
    if use_klt and move_obs:
        move = good & inl & (distinct >= klt_distinct_min)
        du = uv_ref[:, 0] - f_uv_raw[:, 0]
        f_uv_raw = jnp.where(move[:, None], uv_ref, f_uv_raw)
        f_uv = jnp.where(move[:, None], undistort_fn(f_uv_raw), f_uv)
        if ur is not None:
            ur = jnp.where(move & (ur >= 0), ur + du, ur)
        moved = move
    return (R, t, kp_lm, kp_lm_pos, inl, lm_mask, visible,
            f_uv, f_uv_raw, ur, moved, taken, kp_w)


@functools.partial(jax.jit, static_argnames=(
    "project_fn", "project_jac_fn", "undistort_fn", "n_levels",
    "level_slack", "wide_fov", "use_klt", "n_rounds",
    "move_obs"))
def fused_track_rounds(
    project_fn, project_jac_fn, undistort_fn,
    R0, t0,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask, lm_gid,
    lm_patch,
    kp_lm, kp_lm_pos,
    f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
    pyr, level_wh,
    width, height,
    th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8, level_slack=1,
    max_theta_deg=None,
    klt_zncc_min=0.5, klt_max_shift=3.0, klt_distinct_min=0.15,
    wide_fov=False, use_klt=True,
    n_rounds=1, move_obs=True,
    ur_obs=None, bf=None,
    flow=None, flow_radius=40.0,
):
    """Run ``n_rounds`` complete rounds.  Inputs: a padded landmark block
    (lm_*, with lm_gid the global landmark id per row), the frame's
    current bindings kp_lm (global ids) with their positions kp_lm_pos,
    and the frame feature arrays.  ``undistort_fn`` maps raw pixel coords
    to the frame's native matching coords (identity for fisheye-native).

    With ``flow`` (see _flow_prologue) the pose-free image-continuity
    anchor runs first, inside the same program.

    Returns (R, t, kp_lm', inliers, visible_round1,
             (f_uv', f_uv_raw', ur', moved), n_flow) where the primed
    frame coordinate arrays carry every accepted KLT observation move,
    ``moved`` marks the keypoints that moved, and n_flow counts
    flow-anchor bindings."""
    visible_r1 = None
    inl = jnp.zeros(f_uv.shape[0], bool)
    R, t = R0, t0
    ur = ur_obs
    moved_any = jnp.zeros(f_uv.shape[0], bool)
    n_flow = jnp.int32(0)

    if flow is not None:
        kp_lm, kp_lm_pos, lm_mask, (fl_uv_ref, fl_distinct, fl_good), took = \
            _flow_prologue(flow, lm_pos, lm_patch, kp_lm, kp_lm_pos, lm_mask,
                           f_uv, f_level, f_desc, f_valid, f_uv_raw,
                           f_angle, pyr, level_wh, use_klt,
                           klt_zncc_min, klt_max_shift, flow_radius)
        n_flow = took.sum().astype(jnp.int32)
        if use_klt and move_obs:
            move = fl_good & (fl_distinct >= klt_distinct_min)
            du = fl_uv_ref[:, 0] - f_uv_raw[:, 0]
            f_uv_raw = jnp.where(move[:, None], fl_uv_ref, f_uv_raw)
            f_uv = jnp.where(move[:, None], undistort_fn(f_uv_raw), f_uv)
            if ur is not None:
                ur = jnp.where(move & (ur >= 0), ur + du, ur)
            moved_any = moved_any | move

    for _ in range(n_rounds):
        lm_slot, ok, visible = track_match.match_local_map(
            project_fn, R, t,
            lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
            f_uv, f_level, f_desc, f_valid,
            width, height, th=th, nn_ratio=nn_ratio,
            scale_factor=scale_factor,
            n_levels=n_levels, level_slack=level_slack,
            max_theta_deg=max_theta_deg,
        )
        if visible_r1 is None:
            visible_r1 = visible
        free = kp_lm == NO_LM
        cand_ok = ok & free

        tmpl = lm_patch[lm_slot]
        if use_klt:
            uv_ref, zncc, shift, _win, distinct = klt_refine(
                pyr, level_wh, f_uv_raw, f_level, f_angle, tmpl, cand_ok,
                max_shift=klt_max_shift)
            good = cand_ok & (zncc >= klt_zncc_min) & (shift < klt_max_shift)
        else:
            uv_ref = f_uv_raw
            distinct = jnp.full((f_uv.shape[0],), -1.0, jnp.float32)
            good = cand_ok

        new_gid = lm_gid[lm_slot]
        kp_lm_new = jnp.where(good, new_gid, kp_lm)
        X = jnp.where(good[:, None], lm_pos[lm_slot], kp_lm_pos)
        bound = (kp_lm_new != NO_LM) & f_valid
        stereo_kw = {}
        if ur is not None:
            stereo_kw = dict(ur_obs=ur, bf=bf)
        R, t, inl, _ = optimize_pose(
            project_fn, project_jac_fn, R, t, X, f_uv, f_level,
            bound.astype(jnp.float32), wide_fov=wide_fov, **stereo_kw)
        inl = inl & bound
        kp_lm = jnp.where(inl, kp_lm_new, NO_LM).astype(kp_lm.dtype)
        kp_lm_pos = X

        # Inter-round bookkeeping (and final-result state):
        # 1) bound landmarks leave the candidate block;
        taken = jnp.zeros(lm_mask.shape[0], lm_mask.dtype).at[lm_slot].max(
            (good & inl).astype(lm_mask.dtype))
        lm_mask = lm_mask * (1.0 - taken)
        # 2) verified + DISTINCTIVE moves update the observation coords
        # (the anti-aliasing gate of the split path's klt_move_obs).
        if use_klt and move_obs:
            move = good & inl & (distinct >= klt_distinct_min)
            du = uv_ref[:, 0] - f_uv_raw[:, 0]
            f_uv_raw = jnp.where(move[:, None], uv_ref, f_uv_raw)
            f_uv = jnp.where(move[:, None], undistort_fn(f_uv_raw), f_uv)
            if ur is not None:
                ur = jnp.where(move & (ur >= 0), ur + du, ur)
            moved_any = moved_any | move

    return (R, t, kp_lm, inl, visible_r1,
            (f_uv, f_uv_raw, ur, moved_any), n_flow)


@functools.partial(jax.jit, static_argnames=(
    "project_fn", "project_jac_fn", "undistort_fn", "n_levels",
    "wide_fov", "use_klt", "n_local_rounds", "move_obs"))
def fused_track_frame(
    project_fn, project_jac_fn, undistort_fn,
    R0, t0,
    lm_pos, lm_desc, lm_gid, lm_patch,               # (L, ...) combined block
    lm_normal, lm_min_dist, lm_max_dist,             # real gates (local)
    mask_all, mask_wide,                             # (L,)
    kp_lm, kp_lm_pos,
    f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
    pyr, level_wh,
    width, height,
    min_track_matches,
    th_wide=3.0, th_wide_retry=6.0, th_local=1.0,
    nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    wide_slack=7, local_slack=1,
    max_theta_deg=None,
    klt_zncc_min=0.5, klt_max_shift=3.0, klt_distinct_min=0.15,
    wide_fov=False, use_klt=True,
    n_local_rounds=2, move_obs=True,
    ur_obs=None, bf=None,
    flow=None, flow_radius=40.0,
    R_last=None, t_last=None,
    ambig_w=None,
):
    """The WHOLE per-frame tracking slice in ONE program: flow-anchor
    prologue (+ a pose PRE-SOLVE on its pose-free bindings), motion-model
    round (wide gates over the last frame's landmark rows, with an
    in-program widened retry applied only when the first pass bound too
    few), then ``n_local_rounds`` track-local-map rounds over the full
    candidate block — the split path's _track_motion_model +
    _track_local_map sequence with a single dispatch + a single fetched
    result cluster.

    The pre-solve (with R_last/t_last, the LAST frame's pose): the flow
    anchor binds a few hundred features by image continuity alone, so a
    pose GN over just those observations — started from the last pose,
    not the velocity prediction — gives a drift-free re-basing of the
    frame pose BEFORE any pose-gated window search.  Without it, a
    slightly-off velocity prediction centers the wide-round windows one
    texture period away on self-similar texture and the solve locks a
    coherent aliased basin (~10x the true frame-to-frame step; the
    split-path sanity gate then pays a full re-dispatch to recover).
    Applied only when the prologue bound >= 20 features.

    The local candidate block (and the reference-keyframe choice) comes
    from the LAST frame's bindings rather than this frame's motion-model
    result — a one-frame lag in local-map selection; image continuity
    makes the sets near-identical, and the inlier gate on the fetch
    routes genuinely changed frames to the split fallback."""
    R, t = R0, t0
    ur = ur_obs
    moved_any = jnp.zeros(f_uv.shape[0], bool)
    n_flow = jnp.int32(0)
    mask_w = mask_wide
    mask_l = mask_all
    # Wide (frame-to-frame) gates are synthesized in-program from the
    # PREDICTED camera center: a normal pointing at the camera and an
    # unbounded distance band — so the uploaded block is pose-free and
    # cacheable across frames.
    center = -R0.T @ t0
    vecw = lm_pos - center
    lm_normal_w = vecw / jnp.maximum(
        jnp.linalg.norm(vecw, axis=1, keepdims=True), 1e-9)
    lm_min_w = jnp.zeros(lm_pos.shape[0], jnp.float32)
    lm_max_w = jnp.full(lm_pos.shape[0], 1e6, jnp.float32)

    if flow is not None:
        kp_lm, kp_lm_pos, mask_l, (fl_uv_ref, fl_distinct, fl_good), took = \
            _flow_prologue(flow, lm_pos, lm_patch, kp_lm, kp_lm_pos, mask_l,
                           f_uv, f_level, f_desc, f_valid, f_uv_raw,
                           f_angle, pyr, level_wh, use_klt,
                           klt_zncc_min, klt_max_shift, flow_radius)
        n_flow = took.sum().astype(jnp.int32)
        if use_klt and move_obs:
            move = fl_good & (fl_distinct >= klt_distinct_min)
            du = fl_uv_ref[:, 0] - f_uv_raw[:, 0]
            f_uv_raw = jnp.where(move[:, None], fl_uv_ref, f_uv_raw)
            f_uv = jnp.where(move[:, None], undistort_fn(f_uv_raw), f_uv)
            if ur is not None:
                ur = jnp.where(move & (ur >= 0), ur + du, ur)
            moved_any = moved_any | move
        # Pose pre-solve on the pose-free bindings (see docstring): start
        # from the LAST pose and re-base the window-centering pose for
        # every later pose-gated round.
        if R_last is not None:
            bound0 = (kp_lm != NO_LM) & f_valid
            n0 = bound0.sum()
            stereo_kw0 = {} if ur is None else dict(ur_obs=ur, bf=bf)
            R_fl, t_fl, _, _ = optimize_pose(
                project_fn, project_jac_fn, R_last, t_last, kp_lm_pos,
                f_uv, f_level, bound0.astype(jnp.float32),
                wide_fov=wide_fov, **stereo_kw0)
            use_fl = n0 >= 20
            R = jnp.where(use_fl, R_fl, R)
            t = jnp.where(use_fl, t_fl, t)

    common = dict(
        nn_ratio=nn_ratio, scale_factor=scale_factor, n_levels=n_levels,
        max_theta_deg=max_theta_deg, klt_zncc_min=klt_zncc_min,
        klt_max_shift=klt_max_shift, klt_distinct_min=klt_distinct_min,
        wide_fov=wide_fov, use_klt=use_klt, move_obs=move_obs,
        undistort_fn=undistort_fn)

    kp_w = jnp.ones(f_uv.shape[0], jnp.float32)
    if flow is not None and use_klt and ambig_w is not None:
        kp_w = jnp.where((kp_lm != NO_LM)
                         & (fl_distinct < klt_distinct_min),
                         ambig_w, kp_w)

    def run(Rc, tc, kp_lm, kp_lm_pos, mask, wide, th, slack, f_uv,
            f_uv_raw, ur, kp_w, gate=None):
        gates = ((lm_normal_w, lm_min_w, lm_max_w) if wide
                 else (lm_normal, lm_min_dist, lm_max_dist))
        return _round(project_fn, project_jac_fn, Rc, tc,
                      lm_pos, *gates, lm_desc, mask, lm_gid, lm_patch,
                      kp_lm, kp_lm_pos,
                      f_uv, f_level, f_desc, f_valid, f_uv_raw, f_angle,
                      pyr, level_wh, width, height,
                      th, level_slack=slack, ur=ur, bf=bf,
                      apply_gate=gate, kp_w=kp_w, ambig_w=ambig_w,
                      **common)

    # Motion-model round (wide gates over the wide-eligible rows), with
    # the in-program th retry.  Rows bound by ANY round leave the SHARED
    # mask via `taken`.
    R_base, t_base = R, t          # pre-solved (or predicted) restart pose
    (R, t, kp_lm, kp_lm_pos, inl, _mw, _vis, f_uv, f_uv_raw, ur,
     mv, taken, kp_w) = run(R, t, kp_lm, kp_lm_pos, mask_l * mask_w, True,
                            th_wide, wide_slack, f_uv, f_uv_raw, ur, kp_w)
    mask_l = mask_l * (1.0 - taken)
    moved_any = moved_any | mv
    n_bound = (kp_lm != NO_LM).sum()
    need_retry = n_bound < min_track_matches
    # The split path's widened retry RESTARTS from the base pose
    # (a failed narrow pass may have solved into a bad basin).
    R_r = jnp.where(need_retry, R_base, R)
    t_r = jnp.where(need_retry, t_base, t)
    (R, t, kp_lm, kp_lm_pos, inl, _mw, _vis, f_uv, f_uv_raw, ur,
     mv, taken, kp_w) = run(R_r, t_r, kp_lm, kp_lm_pos, mask_l * mask_w,
                            True, th_wide_retry, wide_slack, f_uv,
                            f_uv_raw, ur, kp_w, gate=need_retry)
    mask_l = mask_l * (1.0 - taken)
    moved_any = moved_any | mv
    n_mm = (kp_lm != NO_LM).sum()

    visible_r1 = None
    for _ in range(n_local_rounds):
        (R, t, kp_lm, kp_lm_pos, inl, mask_l, vis, f_uv, f_uv_raw, ur,
         mv, _tk, kp_w) = run(R, t, kp_lm, kp_lm_pos, mask_l, False,
                              th_local, local_slack, f_uv, f_uv_raw, ur,
                              kp_w)
        moved_any = moved_any | mv
        if visible_r1 is None:
            visible_r1 = vis

    return (R, t, kp_lm, inl, visible_r1, n_mm,
            (f_uv, f_uv_raw, ur, moved_any), n_flow)

"""Smoke run of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py                # phases 0-3 on one card
    python chip_smoke.py --four-cards   # distributed bundle adjustment only

Phase 0 checks that JAX sees a GPU (it never falls back to the CPU) and
prints the card, the JAX versions and the compile-cache directory.
Phase 1 compares the perception and solver kernels on the card with the
same programs on the CPU backend of this process, at deployment widths.
Phase 2 runs a monocular ``SlamSystem`` session and phase 3 a stereo one,
both on seeded synthetic worlds scored against their ground truth.
``--four-cards`` runs only the landmark-sharded bundle adjustment over a
4-card mesh and compares it with the one-card solve.

Every check raises on failure; only a run in which every phase passed
prints the closing JSON line.  The script starts no subprocess that uses
JAX: the CPU references run in this process.
"""

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CAM = (458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def report(name, value, tol, why):
    print(f"  {name}: {value}  (tolerance {tol}: {why})")


# --------------------------------------------------------------- phase 0
def preflight():
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # Phase 1 compares against the CPU backend of this process.
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (devices: {jax.devices()}); "
              "this script does not fall back to the CPU", file=sys.stderr)
        sys.exit(2)
    import jaxlib

    import orb_slam3_study_kr_tpu  # noqa: F401  (sets the compile cache)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    print("phase 0: preflight")
    for line in card:
        print(line.strip())
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision} "
          "(full float32 on the card, no TF32)")
    return dev


# --------------------------------------------------------------- problems
def ba_problem(K=16, M=8192, O=32768, seed=0):
    """Seeded BA problem: K poses along x, M landmarks, O observations with
    0.5 px noise, pose 0 fixed."""
    import jax.numpy as jnp

    from orb_slam3_study_kr_tpu import lie
    from orb_slam3_study_kr_tpu.cameras import pinhole

    cam = jnp.asarray(CAM, jnp.float32)
    project_fn = functools.partial(pinhole.project, cam)
    project_jac_fn = functools.partial(pinhole.project_jac, cam)
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-5, 5, M), rng.uniform(-4, 4, M),
                  rng.uniform(5, 15, M)], -1).astype(np.float32)
    Rs, ts = [], []
    for k in range(K):
        R, t = lie.exp_se3(jnp.asarray(
            np.array([0.01 * k, -0.005 * k, 0, 0.2 * k, 0, 0], np.float32)))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
    R0, t0 = np.stack(Rs), np.stack(ts)
    op = rng.integers(0, K, O).astype(np.int32)
    ol = rng.integers(0, M, O).astype(np.int32)
    p = np.einsum("oij,oj->oi", R0[op], X[ol]) + t0[op]
    ouv = (np.asarray(project_fn(jnp.asarray(p)))
           + rng.normal(0, 0.5, (O, 2))).astype(np.float32)
    fixed = np.zeros(K, np.float32)
    fixed[0] = 1.0
    arrays = dict(R=R0, t=t0, fixed=fixed, X=X, lm_mask=np.ones(M, np.float32),
                  op=op, ol=ol, ouv=ouv, olev=np.zeros(O, np.int32),
                  om=np.ones(O, np.float32))
    return project_fn, project_jac_fn, arrays


def matcher_problem(L=4096, N=1024, seed=7):
    """The bench's local-map matcher inputs (random landmarks and keypoints)
    with the first half of the keypoints planted on landmark projections
    (1 px noise, 2% descriptor bits flipped), so that matches exist."""
    import jax.numpy as jnp

    from orb_slam3_study_kr_tpu.cameras import pinhole

    rng = np.random.default_rng(seed)
    project_fn = functools.partial(pinhole.project,
                                   jnp.asarray(CAM, jnp.float32))
    lm_pos = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                       rng.uniform(3, 9, L)], -1).astype(np.float32)
    dirs = lm_pos / np.linalg.norm(lm_pos, axis=-1, keepdims=True)
    lm_desc = (rng.random((L, 256)) < 0.5).astype(np.uint8)
    f_uv = rng.uniform(0, 752, (N, 2)).astype(np.float32)
    f_desc = (rng.random((N, 256)) < 0.5).astype(np.uint8)
    half = N // 2
    f_uv[:half] = (np.asarray(project_fn(jnp.asarray(lm_pos[:half])))
                   + rng.normal(0, 1.0, (half, 2)))
    flip = rng.random((half, 256)) < 0.02
    f_desc[:half] = np.where(flip, 1 - lm_desc[:half], lm_desc[:half])
    lm_min = rng.uniform(0.5, 1, L).astype(np.float32)
    lm_max = rng.uniform(8, 20, L).astype(np.float32)
    f_level = rng.integers(0, 8, N).astype(np.int32)
    # Planted keypoints sit at the landmark's predicted octave.
    ratio = lm_max[:half] / np.linalg.norm(lm_pos[:half], axis=-1)
    f_level[:half] = np.clip(np.ceil(np.log(ratio) / np.log(1.2)), 0, 7)
    arrays = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
              lm_pos, dirs.astype(np.float32), lm_min, lm_max,
              lm_desc, np.ones(L, np.float32), f_uv, f_level, f_desc,
              np.ones(N, bool))
    return project_fn, arrays


# --------------------------------------------------------------- phase 1
def _on(dev, tree):
    import jax
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, dev), tree)


@contextlib.contextmanager
def _unpersisted():
    """Keep CPU executables out of the persistent compile cache: an XLA:CPU
    blob loaded on a host with other CPU features can crash the loader."""
    import jax

    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        yield
    finally:
        jax.config.update(key, old)


def parity_extract(gpu, cpu, height=480, width=752, n_features=1000,
                   n_levels=8):
    import jax

    from orb_slam3_study_kr_tpu.io import synthetic
    from orb_slam3_study_kr_tpu.ops import orb

    cfg = orb.OrbConfig(n_features=n_features, n_levels=n_levels,
                        height=height, width=width)
    rng = np.random.default_rng(5)
    world = synthetic.make_textured_world(rng, width=width, height=height)
    R, t = synthetic.lateral_trajectory(2, x_span=0.1)
    img = synthetic.render_textured(world, R[0], t[0], rng=rng)
    img = img.clip(0, 255).astype(np.uint8).astype(np.float32)
    print(f"extract_orb at {width}x{height}, {n_features} features, "
          f"{n_levels} levels")

    dense = jax.jit(lambda im: orb._dense_stage(
        im, float(cfg.fast_min_threshold), float(cfg.fast_threshold),
        orb.EDGE_MARGIN - 3))
    pyr = jax.jit(lambda im: orb.build_pyramid(im, cfg))
    g = [np.asarray(a) for a in dense(_on(gpu, img))]
    with _unpersisted():
        c = [np.asarray(a) for a in dense(_on(cpu, img))]
        pyr_c = pyr(_on(cpu, img))
        fc = jax.device_get(orb.extract_orb(_on(cpu, img), cfg))
    for name, a, b in (("FAST score", g[0], c[0]), ("NMS high", g[1], c[1]),
                       ("NMS low", g[2], c[2])):
        n_diff = int((a != b).sum())
        report(f"level-0 {name} differing pixels", n_diff, 0,
               "integer-valued input, only min/max/subtract")
        check(n_diff == 0, f"level-0 {name} not bit-exact")
    blur_err = float(np.abs(g[3] - c[3]).max())
    report("level-0 blur max |diff|", blur_err, 1e-3,
           "7x7 f32 weighted sum, summation order and FMA differ")
    check(blur_err <= 1e-3, "blur mismatch")
    lv_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                 for a, b in zip(pyr(_on(gpu, img)), pyr_c))
    report("pyramid levels max |diff|", lv_err, 1e-2,
           "jax.image.resize weights rounded differently on the GPU")
    check(lv_err <= 1e-2, "pyramid mismatch")

    fg = jax.device_get(orb.extract_orb(_on(gpu, img), cfg))
    vg, vc = fg.valid, fc.valid
    same = (vg & vc & (fg.level == fc.level)
            & (np.abs(fg.uv - fc.uv).max(axis=1) < 1e-3))
    share = same.sum() / max(vc.sum(), 1)
    report("valid keypoints coinciding (same slot, level, uv)",
           f"{same.sum()}/{vc.sum()} = {share:.4f}", ">= 0.95",
           "sub-threshold rounding in the resized levels moves a few corners")
    check(share >= 0.95, "too few coinciding keypoints")
    bits = (fg.desc[same] != fc.desc[same]).sum(axis=1)
    exact = float((bits == 0).mean())
    report("coinciding keypoints with bit-identical descriptors",
           f"{exact:.4f} (max differing bits {int(bits.max())})", ">= 0.99",
           "a test whose two bilinear samples tie to f32 rounding can flip")
    check(exact >= 0.99, "descriptor mismatch")


def parity_matcher(gpu, cpu, L=4096, N=1024):
    import jax

    from orb_slam3_study_kr_tpu.ops import matching, track_match

    project_fn, arrays = matcher_problem(L, N)
    print(f"match_local_map at L={L}, N={N}")
    lm_desc, f_desc = arrays[6], arrays[10]
    ham = np.asarray(jax.jit(matching.hamming_matrix)(
        _on(gpu, lm_desc), _on(gpu, f_desc)))
    ref = np.zeros((L, N), np.int32)
    for i in range(0, L, 512):
        ref[i:i + 512] = (lm_desc[i:i + 512, None, :]
                          != f_desc[None, :, :]).sum(-1)
    n_diff = int((ham != ref).sum())
    report("Hamming matrix entries != numpy popcount", n_diff, 0,
           "bf16 {0,1} operands, f32 accumulation: exact")
    check(n_diff == 0, "Hamming distances not exact")

    run = functools.partial(track_match.match_local_map, project_fn,
                            level_slack=1)
    sg, okg, visg = jax.device_get(run(*_on(gpu, arrays), 752, 480, th=3.0))
    with _unpersisted():
        sc, okc, visc = jax.device_get(
            run(*_on(cpu, arrays), 752, 480, th=3.0))
    vis_share = float((visg != visc).mean())
    ok_share = float((okg != okc).mean())
    both = okg & okc
    slot_share = float((sg[both] != sc[both]).mean()) if both.any() else 0.0
    print(f"  matches: GPU {int(okg.sum())}, CPU {int(okc.sum())}")
    for name, v in (("visible", vis_share), ("ok", ok_share),
                    ("slot of common matches", slot_share)):
        report(f"{name} disagreement share", f"{v:.5f}", "<= 0.002",
               "projection rounding flips window-gate boundary cases")
        check(v <= 0.002, f"{name} mismatch")
    check(okc.sum() >= N // 4, "matcher found too few planted matches")


def parity_ba(gpu, cpu, n_iters=10, **size):
    import jax

    from orb_slam3_study_kr_tpu.solvers import bundle_adjust

    project_fn, project_jac_fn, a = ba_problem(**size)
    K, M, O = a["R"].shape[0], a["X"].shape[0], a["op"].shape[0]
    print(f"bundle_adjust K={K}, M={M}, O={O}, {n_iters} LM iterations")
    args = (a["R"], a["t"], a["fixed"], a["X"], a["lm_mask"], a["op"],
            a["ol"], a["ouv"], a["olev"], a["om"])
    outs = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        with _unpersisted() if dev is cpu else contextlib.nullcontext():
            out = bundle_adjust(project_fn, project_jac_fn, *_on(dev, args),
                                n_iters=n_iters)
            outs[name] = [np.asarray(x) for x in jax.device_get(out)]
        print(f"  {name} solve incl. compile {time.perf_counter() - t0:.1f} s")
    (Rg, tg, Xg, chig), (Rc, tc, Xc, chic) = (outs["gpu"][:4],
                                              outs["cpu"][:4])
    for name, v in (("t", tg), ("R", Rg), ("X", Xg), ("chi2", chig)):
        check(np.all(np.isfinite(v)), f"non-finite {name}")
    dt = float(np.abs(tg - tc).max())
    dR = float(np.abs(Rg - Rc).max())
    chi_rel = abs(float(chig.sum()) - float(chic.sum())) / float(chic.sum())
    why = ("f32 segment sums run as GPU atomics, so their order (and the "
           "last bits) change from run to run")
    report("pose translation max |diff| (m)", dt, 1e-3, why)
    report("pose rotation max |diff|", dR, 1e-4, why)
    report("total chi2 relative diff", chi_rel, 1e-3, why)
    check(dt <= 1e-3 and dR <= 1e-4 and chi_rel <= 1e-3, "BA mismatch")


# --------------------------------------------------------------- sessions
class CompileCounter:
    """Counts XLA backend compiles (and their seconds) while active."""

    def __init__(self):
        from jax import monitoring

        self.n, self.secs, self.active = 0, 0.0, False
        monitoring.register_event_duration_secs_listener(self._on)

    EVENT = "/jax/core/compile/backend_compile_duration"

    def _on(self, event, duration, **_):
        if self.active and event == self.EVENT:
            self.n += 1
            self.secs += duration


def mono_session(counter, n_frames=60, height=480, width=752):
    from orb_slam3_study_kr_tpu.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu.io import synthetic
    from orb_slam3_study_kr_tpu.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu.pipeline.tracking import TrackState

    print(f"mono SlamSystem, async mapping, {width}x{height}, "
          f"{n_frames} frames")
    rng = np.random.default_rng(5)
    world = synthetic.make_textured_world(rng, width=width, height=height)
    R, t = synthetic.lateral_trajectory(n_frames, x_span=1.0)
    imgs = [synthetic.render_textured(world, R[i], t[i], rng=rng)
            .clip(0, 255).astype(np.uint8) for i in range(n_frames)]
    slam = SlamSystem(SystemConfig(sensor="mono", async_mapping=True))
    counter.n, counter.secs, counter.active = 0, 0.0, True
    t0 = time.perf_counter()
    handle = slam.upload_image(imgs[0])
    for i in range(n_frames):
        nxt = slam.upload_image(imgs[i + 1]) if i + 1 < n_frames else None
        slam.track_monocular(handle, i * 0.05)
        handle = nxt
    slam.flush()
    counter.active = False
    wall = time.perf_counter() - t0
    try:
        stats = slam.tracker.stats
        warm = np.asarray(slam.timings[n_frames // 2:]) * 1e3
        rows = slam.trajectory()
        path = tempfile.mkdtemp(prefix="chip_smoke_") + "/mono_traj_tum.txt"
        slam.save_trajectory_tum(path)
        centers = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)
        rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4],
                               np.arange(n_frames) * 0.05, centers, True)
        n_fused = stats.get("fused_frame", 0)
        n_fb = stats.get("fused_frame_fallback", 0)
        print(f"  warm ms/frame (frames {n_frames // 2}-{n_frames - 1}): "
              f"median {np.median(warm):.2f}, p90 "
              f"{np.percentile(warm, 90):.2f}, max {warm.max():.2f}")
        print(f"  session wall {wall:.1f} s; compiles in session "
              f"{counter.n} ({counter.secs:.1f} s)")
        print(f"  keyframes {stats['n_kf']}, fused frames {n_fused}, "
              f"fused fallbacks {n_fb} "
              f"(share {n_fb / max(n_fused + n_fb, 1):.3f})")
        print(f"  scale-aligned ATE {rmse:.4f} m over {nm} frames "
              f"(wall 0.06); trajectory {path}")
        check(slam.state == TrackState.OK, f"mono state {slam.state}")
        check(stats["n_kf"] >= 3, "fewer than 3 keyframes")
        check(n_fused >= 1, "no frame took the fused whole-frame program")
        check(rmse < 0.06, f"mono ATE {rmse:.4f} >= 0.06")
    finally:
        slam.shutdown()


def stereo_session(n_frames=30, height=480, width=752, baseline=0.11):
    from orb_slam3_study_kr_tpu.evaluation import ate_rmse
    from orb_slam3_study_kr_tpu.io import synthetic
    from orb_slam3_study_kr_tpu.pipeline import SlamSystem, SystemConfig
    from orb_slam3_study_kr_tpu.pipeline.tracking import (TrackerConfig,
                                                          TrackState)

    print(f"stereo SlamSystem, {width}x{height}, {n_frames} frames")
    rng = np.random.default_rng(3)
    world = synthetic.make_textured_world(rng, width=width, height=height,
                                          depth=6.0)
    R, t = synthetic.lateral_trajectory(n_frames, x_span=1.0, z_span=0.0,
                                        y_amp=0.0)
    slam = SlamSystem(SystemConfig(sensor="stereo", baseline=baseline,
                                   tracker=TrackerConfig(fps=10)))
    try:
        for i in range(n_frames):
            img_l = synthetic.render_textured(world, R[i], t[i], rng=rng)
            _, t_r = synthetic.stereo_right_pose(R[i], t[i], baseline)
            img_r = synthetic.render_textured(world, R[i], t_r, rng=rng)
            slam.track_stereo(img_l, img_r, i * 0.1)
        rows = slam.trajectory()
        centers = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)
        ts = np.arange(n_frames) * 0.1
        rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, centers, False)
        _, _, s = ate_rmse(rows[:, 0], rows[:, 1:4], ts, centers, True)
        print(f"  metric ATE {rmse:.4f} m over {nm} frames (wall 0.15), "
              f"scale {s:.4f} (wall |s - 1| < 0.10)")
        check(slam.state == TrackState.OK, f"stereo state {slam.state}")
        check(nm > 20 and rmse < 0.15, f"stereo ATE {rmse:.4f} ({nm})")
        check(abs(s - 1.0) < 0.10, f"stereo scale {s:.3f}")
    finally:
        slam.shutdown()


# --------------------------------------------------------------- 4 cards
def four_cards(devices, n_iters=10, **size):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from orb_slam3_study_kr_tpu.parallel import (distributed_bundle_adjust,
                                                 make_ba_mesh)
    from orb_slam3_study_kr_tpu.parallel.dist_ba import shard_ba_problem
    from orb_slam3_study_kr_tpu.solvers import bundle_adjust

    n = len(devices)
    mesh = make_ba_mesh(devices)
    project_fn, project_jac_fn, a = ba_problem(**size)
    K, M, O = a["R"].shape[0], a["X"].shape[0], a["op"].shape[0]
    print(f"distributed BA over a flat {n}-card mesh: K={K}, M={M}, O={O}, "
          f"{n_iters} LM iterations")
    (X_sh, lmm_sh, op_sh, ol_sh, ouv_sh, olev_sh, om_sh, dev_of_lm,
     local_of_lm, Mb, _) = shard_ba_problem(
        mesh, n, a["X"], a["lm_mask"], a["op"], a["ol"], a["ouv"],
        a["olev"], a["om"])
    shd, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    put = lambda x, s: jax.device_put(jnp.asarray(x), s)
    sharded = (put(a["R"], rep), put(a["t"], rep), put(a["fixed"], rep),
               put(X_sh, shd), put(lmm_sh, shd), put(op_sh, shd),
               put(ol_sh, shd), put(ouv_sh, shd), put(olev_sh, shd),
               put(om_sh, shd))
    single = _on(devices[0], tuple(jnp.asarray(a[k]) for k in (
        "R", "t", "fixed", "X", "lm_mask", "op", "ol", "ouv", "olev", "om")))
    why = ("the psum of per-card partial systems sums in another order than "
           "one card's atomics")
    # Landmarks seen from one or two poses are undetermined along the ray:
    # their damped updates amplify last-bit differences, so they are only
    # reported; the check holds the landmarks seen from >= 3 poses.
    pairs = np.unique(np.stack([a["ol"], a["op"]], 1), axis=0)
    n_views = np.bincount(pairs[:, 0], minlength=M)
    held = n_views >= 3
    for assembly in ("dense_chunked", "pcg"):
        t0 = time.perf_counter()
        R_d, t_d, X_d, chi_d = distributed_bundle_adjust(
            mesh, project_fn, project_jac_fn, *sharded, n_iters=n_iters,
            assembly=assembly)
        jax.block_until_ready(X_d)
        secs = time.perf_counter() - t0
        shard_devs = {s.device for s in X_d.addressable_shards}
        check(len(X_d.sharding.device_set) == n and len(shard_devs) == n,
              "landmark shards are not on distinct cards")
        ref_assembly = "pcg" if assembly == "pcg" else "dense"
        R_s, t_s, X_s, chi_s = jax.device_get(bundle_adjust(
            project_fn, project_jac_fn, *single, n_iters=n_iters,
            assembly=ref_assembly)[:4])
        X_d = np.asarray(X_d).reshape(n, Mb, 3)[dev_of_lm, local_of_lm]
        dt = float(np.abs(np.asarray(t_d) - t_s).max())
        dX = np.abs(X_d - X_s).max(axis=1)
        chi_d = float((np.asarray(chi_d) * om_sh).sum())
        chi_rel = abs(chi_d - float(chi_s.sum())) / float(chi_s.sum())
        print(f"  {assembly}: solve incl. compile {secs:.1f} s; landmark "
              f"shards on {len(shard_devs)} distinct cards")
        vs = f"{assembly} vs one-card {ref_assembly}"
        report(f"{vs}: pose t max |diff| (m)", dt, 1e-3, why)
        report(f"{vs}: total chi2 relative diff", chi_rel, 1e-3, why)
        report(f"{vs}: landmark max |diff| (m), {held.sum()} seen from >= 3 "
               f"poses", float(dX[held].max()), 1e-2, why)
        print(f"  {vs}: landmark max |diff| over all {M}: "
              f"{float(dX.max())} (99th percentile "
              f"{float(np.percentile(dX, 99))}; not held, see above)")
        check(np.all(np.isfinite(np.asarray(R_d))), "non-finite poses")
        check(dt <= 1e-3 and chi_rel <= 1e-3 and dX[held].max() <= 1e-2,
              f"{assembly} disagrees")
    global_ba_on_mesh(mesh, project_fn)


def global_ba_on_mesh(mesh, project_fn):
    """The pipeline's global-BA entry point routed over the mesh, on a
    4-keyframe map (the loop closer's path with ``ba_devices`` set)."""
    import jax.numpy as jnp

    from orb_slam3_study_kr_tpu.pipeline.global_ba import (
        global_bundle_adjustment)
    from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig
    from orb_slam3_study_kr_tpu.slam_map.map_state import NO_LM, MapState
    from orb_slam3_study_kr_tpu import lie

    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-3, 3, 32), rng.uniform(-2, 2, 32),
                  rng.uniform(5, 9, 32)], -1).astype(np.float32)
    max_kp = 64
    m = MapState(max_kf=8, max_kp=max_kp, max_lm=512)
    lm_ids = m.add_landmarks(X, (rng.random((32, 256)) > 0.5).astype(np.uint8),
                             first_kf=0)
    for k in range(4):
        R, t = (np.asarray(v) for v in lie.exp_se3(jnp.asarray(
            np.array([0.01 * k, 0, 0, 0.2 * k, 0, 0], np.float32))))
        uv = np.zeros((max_kp, 2), np.float32)
        uv[:32] = np.asarray(project_fn(jnp.asarray(X @ R.T + t)))
        valid = np.zeros(max_kp, bool)
        valid[:32] = True
        kp_lm = np.full(max_kp, NO_LM, np.int32)
        kp_lm[:32] = lm_ids
        m.add_keyframe(R, t, uv, np.zeros(max_kp, np.int32),
                       np.zeros(max_kp, np.float32), valid,
                       (rng.random((max_kp, 256)) > 0.5).astype(np.uint8),
                       frame_id=k, timestamp=0.1 * k, kp_lm=kp_lm)
    check(global_bundle_adjustment(TrackerConfig(), m, n_iters=2, mesh=mesh),
          "global BA over the mesh failed")
    check(np.all(np.isfinite(m.kf_t[:4])), "non-finite keyframe poses")
    print("  global_bundle_adjustment(mesh=...) on a 4-keyframe map: ok")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card distributed bundle adjustment")
    args = ap.parse_args(argv)
    gpu = preflight()
    import jax

    if args.four_cards:
        devices = jax.devices()[:4]
        check(len(devices) == 4, f"--four-cards needs 4 GPUs, found "
              f"{len(jax.devices())}")
        four_cards(devices)
    else:
        cpu = jax.devices("cpu")[0]
        counter = CompileCounter()
        print("phase 1: parity, GPU vs CPU backend")
        parity_extract(gpu, cpu)
        parity_matcher(gpu, cpu)
        parity_ba(gpu, cpu)
        print("phase 2: mono session")
        mono_session(counter)
        print("phase 3: stereo session")
        stereo_session()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()

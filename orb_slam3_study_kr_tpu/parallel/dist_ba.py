"""Distributed bundle adjustment over a device mesh.

What the reference cannot do at all (its BA is one g2o solve on one
thread), over the cards of one host.  Decomposition, following the standard
distributed-Schur structure (BASELINE.json north star):

- landmarks (and their observations) are sharded across devices along a
  `data` mesh axis — each landmark's full observation set lives on exactly
  one device, so the 3x3 elimination blocks are device-local;
- camera poses are replicated;
- each device builds its partial reduced camera system from its
  observations and the partials are combined with psum;
- landmark updates back-substitute locally with zero communication.

Two assemblies (matching solvers/local_ba.bundle_adjust):
- "dense": each device materializes its (K, M_blk, 6, 3) cross block and
  psums the (6K, 6K) reduced system once per iteration — communication
  independent of landmark/observation count; best for windowed BA.
- "pcg": matrix-free preconditioned CG on the reduced system; each CG
  matvec psums one (K, 6) vector (plus a (M->K) segment sweep) — best for
  full-map GBA where 6K is large.

Supports the reference's third stereo residual row via obs_ur/bf
(EdgeStereoSE3ProjectXYZ) and returns per-observation chi2 for the
caller's outlier culling, exactly like the single-device solver.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orb_slam3_study_kr_tpu.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu.solvers import robust
from orb_slam3_study_kr_tpu.solvers.local_ba import _schur_pcg
from orb_slam3_study_kr_tpu.solvers.reproj import residual_and_jacobians


def make_ba_mesh(devices=None, axis="data"):
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def collectives_per_iter(assembly: str, n_cg: int = 60) -> int:
    """psum count per LM iteration (reported by bench.py): the dense
    assemblies pay a CONSTANT 5 collectives (Hpp, bp, S, rhs, cost)
    regardless of problem size or inner-solver depth; the matrix-free PCG
    assembly pays one per CG matvec on top of its setup."""
    return 5 if assembly in ("dense", "dense_chunked") else n_cg + 5


def distributed_bundle_adjust(
    mesh,
    project_fn, project_jac_fn,
    R_cw, t_cw, fixed,          # (K,3,3), (K,3), (K,)  — replicated
    X, lm_mask,                 # (Msh,3), (Msh,)       — sharded by landmark
    obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # (Osh,) — sharded with
                                # obs_lm indexing into the LOCAL landmark block
    n_iters: int = 10,
    init_lambda: float = 1e-4,
    obs_ur=None, bf=None,       # sharded (Osh,) right-u; bf = fx * baseline
    assembly: str = "dense",    # "dense" | "dense_chunked" | "pcg"
    n_cg: int = 60,
    wide_fov: bool = False,     # fisheye: |p| > 0 cheirality, not z > 0
):
    """LM-damped Schur-complement BA over the mesh.

    Shapes: X/lm_mask sharded on axis 0 into equal per-device blocks; the
    obs_* arrays sharded on axis 0 such that each observation lives with its
    landmark's device, and obs_lm holds *local* (per-shard) landmark indices.
    Poses are replicated.  Returns (R_cw, t_cw, X, chi2) with the same
    shardings (chi2 sharded like the observations).

    The jitted shard_map solver is CACHED per (mesh, camera fns, solver
    statics): repeated solves — every loop-closure GBA, every bench rep —
    reuse one compiled program instead of re-tracing the whole LM scan
    (re-tracing dominated multi-host wall time in round 4's bench)."""
    solver = _build_dist_solver(
        mesh, project_fn, project_jac_fn, int(n_iters), float(init_lambda),
        obs_ur is not None, str(assembly), int(n_cg), bool(wide_fov))
    args = [R_cw, t_cw, fixed, X, lm_mask, obs_pose, obs_lm, obs_uv,
            obs_level, obs_mask]
    if obs_ur is not None:
        import jax.numpy as _jnp
        args += [obs_ur, _jnp.asarray(bf, R_cw.dtype)]
    return solver(*args)


@functools.lru_cache(maxsize=64)
def _build_dist_solver(mesh, project_fn, project_jac_fn, n_iters,
                       init_lambda, has_ur, assembly, n_cg, wide_fov):
    axis = mesh.axis_names[0]
    rep = P()
    shd = P(axis)
    in_specs = [rep, rep, rep, shd, shd, shd, shd, shd, shd, shd]
    if has_ur:
        in_specs += [shd, rep]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(rep, rep, shd, shd),
        check_vma=False,
    )
    def solve(R_all, t_all, fixed, X_blk, lmm_blk, op, ol, ouv, olev, om,
              our=None, bf=None):
        K = R_all.shape[0]
        inv_sigma2 = robust.octave_inv_sigma2(olev)
        M_blk = X_blk.shape[0]
        dt = R_all.dtype
        psum = lambda x: jax.lax.psum(x, axis)
        if has_ur:
            chi2_gate = jnp.where(our >= 0, robust.CHI2_STEREO,
                                  robust.CHI2_MONO)
        else:
            chi2_gate = robust.CHI2_MONO
        huber_delta = jnp.sqrt(jnp.asarray(chi2_gate, dt))

        def _huber_rho(chi2):
            d2 = chi2_gate
            d = huber_delta
            rr = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            return jnp.where(chi2 <= d2, chi2, 2 * d * rr - d2)

        def compute(R_all, t_all, X_blk):
            r, J_pose, J_point, p = residual_and_jacobians(
                project_jac_fn, project_fn, R_all[op], t_all[op], X_blk[ol],
                ouv, ur_obs=our if has_ur else None, bf=bf)
            chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
            # Same cheirality gate as solvers/local_ba.py: KB8 keeps
            # observations past 90 deg off-axis (z may be <= 0 there).
            cheir = (jnp.linalg.norm(p, axis=-1) > 1e-3) if wide_fov \
                else (p[:, 2] > 1e-3)
            valid = om * lmm_blk[ol] * cheir
            w = inv_sigma2 * valid * robust.huber_weight(chi2, huber_delta)
            cost_loc = jnp.sum(_huber_rho(chi2) * valid)
            return r, J_pose, J_point, w, chi2, cost_loc

        def gn_iter(carry, _):
            R_all, t_all, X_blk, lam, cost_prev = carry
            r, J_pose, J_point, w, chi2, _ = compute(R_all, t_all, X_blk)
            free = (1.0 - fixed)[op]
            Jp = J_pose * free[:, None, None]

            Hpp = psum(jnp.zeros((K, 6, 6), dt).at[op].add(
                jnp.einsum("nia,n,nib->nab", Jp, w, Jp)))
            bp = psum(jnp.zeros((K, 6), dt).at[op].add(
                jnp.einsum("nia,n,ni->na", Jp, w, r)))
            Hll = jnp.zeros((M_blk, 3, 3), dt).at[ol].add(
                jnp.einsum("nia,n,nib->nab", J_point, w, J_point))
            bl = jnp.zeros((M_blk, 3), dt).at[ol].add(
                jnp.einsum("nia,n,ni->na", J_point, w, r))
            E = jnp.einsum("nia,n,nib->nab", Jp, w, J_point)  # (O, 6, 3)

            eye3 = jnp.eye(3, dtype=dt)
            eye6 = jnp.eye(6, dtype=dt)
            Hll_d = Hll + lam * (eye3[None] + Hll * eye3[None])
            Hll_inv = jnp.linalg.inv(Hll_d) * lmm_blk[:, None, None]
            Hpp_d = Hpp + lam * (eye6[None] + Hpp * eye6[None])

            if assembly in ("dense", "dense_chunked"):
                # Communication-avoiding assembly: the (6K, 6K) reduced
                # camera system is accumulated LOCALLY (scanning landmark
                # chunks so the (K, C, 6, 3) cross block stays bounded)
                # and combined with ONE psum per LM iteration — collective
                # count independent of landmark/observation count and of
                # any inner-solver iteration count.  This replaces the
                # per-CG-matvec psum structure (~60 collectives per LM
                # iteration) that dominated multi-host BA time
                # (VERDICT round 4 #6).
                C = M_blk if assembly == "dense" else min(M_blk, 2048)
                n_chunks = -(-M_blk // C)
                Mp = n_chunks * C
                pad = Mp - M_blk
                Hinv_p = jnp.pad(Hll_inv, ((0, pad), (0, 0), (0, 0)))
                bl_p = jnp.pad(bl, ((0, pad), (0, 0)))

                def chunk_body(carry, c0):
                    S_acc, rhs_acc = carry
                    ol_c = ol - c0
                    Wc = jnp.zeros((K, C, 6, 3), dt).at[op, ol_c].add(
                        E, mode="drop")
                    Hinv_c = jax.lax.dynamic_slice_in_dim(Hinv_p, c0, C, 0)
                    bl_c = jax.lax.dynamic_slice_in_dim(bl_p, c0, C, 0)
                    Wi = jnp.einsum("kmab,mbc->kmac", Wc, Hinv_c)
                    S_acc = S_acc - jnp.einsum(
                        "kmac,lmbc->kalb", Wi, Wc).reshape(6 * K, 6 * K)
                    rhs_acc = rhs_acc + jnp.einsum(
                        "kmab,mb->ka", Wi, bl_c).reshape(6 * K)
                    return (S_acc, rhs_acc), None

                (S_part, rhs_corr), _ = jax.lax.scan(
                    chunk_body,
                    (jnp.zeros((6 * K, 6 * K), dt), jnp.zeros(6 * K, dt)),
                    jnp.arange(n_chunks) * C)
                # bp is already psummed; divide by the STATIC device count
                # so the rhs psum below does not double-count it.
                n_dev = float(mesh.devices.size)
                rhs_part = -(bp / n_dev).reshape(6 * K) + rhs_corr
                S = psum(S_part) + _blockdiag6(Hpp_d, K)
                rhs = psum(rhs_part)
                fixd = jnp.repeat(fixed, 6)
                S = S * (1 - fixd)[:, None] * (1 - fixd)[None, :] \
                    + jnp.diag(fixd)
                dp = jnp.linalg.solve(S, rhs).reshape(K, 6)
            else:
                dp = _schur_pcg(Hpp_d, bp, Hll_inv, bl, E, op, ol,
                                fixed, n_cg, psum_fn=psum)

            Wtdp = jnp.zeros((M_blk, 3), dt).at[ol].add(
                jnp.einsum("nab,na->nb", E, dp[op]))
            dl = -jnp.einsum("mab,mb->ma", Hll_inv, bl + Wtdp)

            dR, dtv = exp_se3(dp)
            R_new, t_new = se3_compose(dR, dtv, R_all, t_all)
            X_new = X_blk + dl * lmm_blk[:, None]
            cost_new = psum(compute(R_new, t_new, X_new)[5])
            accept = cost_new < cost_prev
            R_all = jnp.where(accept, R_new, R_all)
            t_all = jnp.where(accept, t_new, t_all)
            X_blk = jnp.where(accept, X_new, X_blk)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e3))
            cost = jnp.where(accept, cost_new, cost_prev)
            return (R_all, t_all, X_blk, lam, cost), None

        cost0 = psum(compute(R_all, t_all, X_blk)[5])
        init = (R_all, t_all, X_blk, jnp.asarray(init_lambda, dt), cost0)
        (R_f, t_f, X_f, _, _), _ = jax.lax.scan(gn_iter, init, None,
                                                length=n_iters)
        chi2_f = compute(R_f, t_f, X_f)[4]
        return R_f, t_f, X_f, chi2_f

    return jax.jit(solve)


def _blockdiag6(Hb, K):
    out = jnp.zeros((K, 6, K, 6), Hb.dtype)
    out = out.at[jnp.arange(K), :, jnp.arange(K), :].set(Hb)
    return out.reshape(6 * K, 6 * K)


def shard_ba_problem(mesh, n_devices, X, lm_mask, obs_pose, obs_lm, obs_uv,
                     obs_level, obs_mask, obs_ur=None):
    """Host-side partitioner: round-robin landmarks into equal blocks, route
    each observation to its landmark's device, convert obs_lm to local
    indices, and pad every shard to a common size.

    Returns device-ready (X, lm_mask, obs_*, [obs_ur], dev_of_lm,
    local_of_lm, Mb) numpy arrays (concatenated shards — apply
    jax.device_put with a NamedSharding over axis 0)."""
    import numpy as np

    M = X.shape[0]
    Mb = -(-M // n_devices)
    dev_of_lm = np.arange(M) % n_devices
    local_of_lm = np.arange(M) // n_devices

    X_sh = np.zeros((n_devices, Mb, 3), X.dtype)
    lmm_sh = np.zeros((n_devices, Mb), lm_mask.dtype)
    for d in range(n_devices):
        sel = dev_of_lm == d
        X_sh[d, : sel.sum()] = X[sel]
        lmm_sh[d, : sel.sum()] = lm_mask[sel]

    dev_of_obs = dev_of_lm[obs_lm]
    per_dev = [np.nonzero(dev_of_obs == d)[0] for d in range(n_devices)]
    Ob = max(max(len(p) for p in per_dev), 1)
    op_sh = np.zeros((n_devices, Ob), obs_pose.dtype)
    ol_sh = np.zeros((n_devices, Ob), obs_lm.dtype)
    ouv_sh = np.zeros((n_devices, Ob, 2), obs_uv.dtype)
    olev_sh = np.zeros((n_devices, Ob), obs_level.dtype)
    om_sh = np.zeros((n_devices, Ob), obs_mask.dtype)
    our_sh = np.full((n_devices, Ob), -1.0, np.float32)
    obs_slot = np.full((n_devices, Ob), -1, np.int64)  # global obs index
    for d, idx in enumerate(per_dev):
        n = len(idx)
        op_sh[d, :n] = obs_pose[idx]
        ol_sh[d, :n] = local_of_lm[obs_lm[idx]]
        ouv_sh[d, :n] = obs_uv[idx]
        olev_sh[d, :n] = obs_level[idx]
        om_sh[d, :n] = obs_mask[idx]
        obs_slot[d, :n] = idx
        if obs_ur is not None:
            our_sh[d, :n] = obs_ur[idx]
    out = [
        X_sh.reshape(-1, 3), lmm_sh.reshape(-1),
        op_sh.reshape(-1), ol_sh.reshape(-1), ouv_sh.reshape(-1, 2),
        olev_sh.reshape(-1), om_sh.reshape(-1),
    ]
    if obs_ur is not None:
        out.append(our_sh.reshape(-1))
    out += [dev_of_lm, local_of_lm, Mb, obs_slot.reshape(-1)]
    return tuple(out)

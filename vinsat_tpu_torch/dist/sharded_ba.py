"""The arc-sharded LM step (port of vinsat_tpu/dist/sharded_ba.py).

Problem arrays are laid out (B, P, Nl, ...): B independent orbits, the
knots of each split contiguously into P arc shards of Nl knots (the
("orbit", "arc") mesh of dist/mesh.py on one device).  Observations use a
fixed per-knot budget of D slots, so the normal-equation blocks of a knot
are a reduction over its own slots: kernel K2 (kernels/normal_eq) on the
card, its plain twin on the CPU, once per iteration over all B·P·Nl knots.

The per-shard structure of the JAX program is kept, with its collectives
as dist/mesh.py operations along the arc dimension:
  * a halo: each shard receives its right neighbour's first knot state, to
    form the boundary dynamics pair;
  * the boundary pair's (BᵀB, Hq, Bᵀr, quaternion gradient) contributions
    pushed right to the knot that owns them;
  * psum / pmax for the distributed median scale, the weight normalisation
    and the residual means;
  * the SPIKE solve of dist/tridiag.
JAX's vmaps over orbits and over the K λ candidates become leading
dimensions; the λ candidates (K, B) come first.

An optional per-knot marginal prior (`ShardedPrior`, the BA_reg factor of
the bounded stream's anchor) is block-diagonal in knots and needs no
communication.  `make_sharded_window_solver` runs a whole window's LM
chain on the mesh: the solver behind the sharded stream (dist/stream).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from vinsat_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from vinsat_tpu_torch.core import quat
from vinsat_tpu_torch.dist import mesh as mesh_mod
from vinsat_tpu_torch.dist.tridiag import _shard_body
from vinsat_tpu_torch.estimation import factors, window
from vinsat_tpu_torch.estimation.ba import BAStep, SolverParams
from vinsat_tpu_torch.kernels.normal_eq import assemble_normal_eq


class ShardedProblem(NamedTuple):
    """Per-knot-budget problem arrays, orbit-major, arc-sharded.

    states   (B, P, Nl, 10)
    gaps     (B, P, Nl)
    cum_rot  (B, P, Nl, 4)
    lm_xyz   (B, P, Nl, D, 3)   landmark ECI positions per observation slot
    uv       (B, P, Nl, D, 2)
    conf     (B, P, Nl, D)
    obs_valid(B, P, Nl, D)
    pair_valid(B, P, Nl)        1 if the dynamics pair (t, t+1) is active
    intrinsics (4,)
    knot_valid(B, P, Nl)        1 for real (non-padding) knots; None = all
    """

    states: torch.Tensor
    gaps: torch.Tensor
    cum_rot: torch.Tensor
    lm_xyz: torch.Tensor
    uv: torch.Tensor
    conf: torch.Tensor
    obs_valid: torch.Tensor
    pair_valid: torch.Tensor
    intrinsics: torch.Tensor
    knot_valid: Optional[torch.Tensor] = None


class ShardedPrior(NamedTuple):
    """Per-knot marginal prior of the sharded BA_reg path (ba.PriorState
    laid out like ShardedProblem).  Knots without a prior carry valid = 0.

    prop_states (B, P, Nl, 10); H_state (B, P, Nl, 6, 6);
    H_rot (B, P, Nl, 3, 3); valid (B, P, Nl)."""

    prop_states: torch.Tensor
    H_state: torch.Tensor
    H_rot: torch.Tensor
    valid: torch.Tensor


def sharded_problem_from_numpy(fields: Mapping[str, np.ndarray], n_arc: int,
                               device=DEFAULT_DEVICE,
                               dtype=torch.float64) -> ShardedProblem:
    """ShardedProblem from the JAX ShardedProblem's fields as numpy arrays
    (`{k: np.asarray(v) for k, v in prob._asdict().items()}`), whose knot
    arrays are (B, N, ...): split into (B, n_arc, N / n_arc, ...)."""
    device = resolve_device(device)
    out = {}
    for name in ShardedProblem._fields:
        a = fields.get(name)
        if a is None or (isinstance(a, np.ndarray) and a.dtype == object):
            out[name] = None
            continue
        a = np.array(a)  # a copy: the source may be read-only
        if name != "intrinsics":
            B, N = a.shape[:2]
            if N % n_arc:
                raise ValueError(f"{name}: N={N} does not divide into "
                                 f"{n_arc} arc shards")
            a = a.reshape((B, n_arc, N // n_arc) + a.shape[2:])
        out[name] = torch.as_tensor(a, dtype=dtype, device=device)
    return ShardedProblem(**out)


def _local_sum(x, nd: int):
    """A shard's own sum over its trailing nd dims."""
    return x.sum(tuple(range(-nd, 0)))


def _distributed_median_abs(x, valid_mask, bins: int = 16384,
                            refine: int = 8, mesh=None):
    """Median of |x| over valid entries, per orbit, across all arc shards
    of `mesh` (None: one device).  x (B, P, ...); valid_mask broadcastable
    to x.  Returns (B,).

    One pmax for the range, one psum of a `bins`-bin log-spaced histogram
    per shard, from whose cumulative counts the median bin follows, then
    `refine` bisection psums inside that bin (bin_width / 2^refine)."""
    dtype = x.dtype
    B, P = x.shape[:2]
    nd = x.dim() - 2
    ax = x.abs()
    vm = valid_mask.expand(ax.shape)
    vmf = vm.to(dtype)
    n_tot = mesh_mod.psum(_local_sum(vmf, nd), dim=1, mesh=mesh)[:, 0]
    hi0 = mesh_mod.pmax(
        torch.where(vm, ax, torch.zeros_like(ax)).reshape(B, P, -1).amax(-1),
        dim=1, mesh=mesh)[:, 0]
    hi0 = torch.clamp(hi0, min=1e-30)
    lo0 = hi0 * 1e-9

    # log-spaced bin index per element; values <= lo0 land in bin 0
    ratio = torch.log(hi0 / lo0)
    bshape = (B,) + (1,) * (nd + 1)
    lo0_b = lo0.view(bshape)
    t = torch.log(torch.maximum(ax, lo0_b) / lo0_b) / ratio.view(bshape)
    # the int cast truncates toward zero, as JAX's astype(int32)
    idx = torch.clamp((t * bins).to(torch.int64), 0, bins - 1)
    hist = torch.zeros((B * P, bins), dtype=dtype, device=x.device)
    hist.scatter_add_(1, idx.reshape(B * P, -1), vmf.reshape(B * P, -1))
    hist = mesh_mod.psum(hist.view(B, P, bins), dim=1, mesh=mesh)[:, 0]
    cum = torch.cumsum(hist, dim=-1)
    # argmax of the first bin reaching half the count (ties: first index)
    med_bin = torch.argmax((cum >= 0.5 * n_tot[:, None]).to(torch.int32),
                           dim=-1).to(dtype)
    lo = lo0 * torch.exp(ratio * med_bin / bins)
    hi = lo0 * torch.exp(ratio * (med_bin + 1.0) / bins)
    lo = torch.where(med_bin == 0, torch.zeros_like(lo), lo)

    for _ in range(refine):
        mid = 0.5 * (lo + hi)
        cnt = mesh_mod.psum(
            _local_sum((vm & (ax <= mid.view(bshape))).to(dtype), nd),
            dim=1, mesh=mesh)[:, 0]
        below = cnt < 0.5 * n_tot
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _schedule(sched_iter, dtype, params: SolverParams):
    """α, |α - 2| guard, Σ and sqrt(Σ) of the schedule index, computed in
    the problem's dtype (as the JAX step does) and handed on as floats."""
    it = torch.tensor(float(sched_iter), dtype=dtype)
    alpha = torch.clamp(1.0 - (2.0 * (it / 5.0) - 1.0), 1.0, 2.0)
    denom = torch.clamp((alpha - 2.0).abs(), min=1e-12)
    sigma = torch.clamp(params.sigma_scale * (it + 1.0) ** 2,
                        max=params.sigma_max)
    return alpha.item(), denom.item(), sigma.item(), torch.sqrt(sigma).item()


def _one_orbit_iteration(sched_iter, lamda, prob: ShardedProblem,
                         params: SolverParams, initialize: float = 0.0,
                         use_pallas_assembly: bool = False,
                         prior: Optional[ShardedPrior] = None,
                         mesh: Optional[mesh_mod.Mesh] = None,
                         quat_coeff_prior: float = 1.0,
                         vel_coeff_prior: float = 1.0):
    """One LM iteration of every orbit of `prob` (all B at once, each over
    its P arc shards: all of them on one device, or this rank's block of
    `mesh`'s on ranks).  lamda (B,).  `use_pallas_assembly` keeps the JAX
    flag's meaning: kernel K2 assembles in f32 and casts back; otherwise K2
    assembles in the problem's dtype.  `prior` adds the BA_reg prior factor
    (factors.prior_factor, valid = prior.valid * knot_valid, weighted by
    quat_coeff_prior / vel_coeff_prior); knot_valid enters only the prior's
    residual-mean denominator, as in the JAX step.
    Returns (states_new (B, P, Nl, 10), lam_next (B,), accepted trial
    residual (B,))."""
    states = prob.states
    dtype, dev = states.dtype, states.device
    B, P, Nl = states.shape[:3]
    D = prob.uv.shape[-2]
    BPN = B * P * Nl
    qc, vc = params.quat_coeff, params.vel_coeff
    ov, conf, pv = prob.obs_valid, prob.conf, prob.pair_valid
    lm_flat = prob.lm_xyz.reshape(BPN * D, 3)
    ii = torch.arange(BPN, device=dev).repeat_interleave(D)
    intr = prob.intrinsics

    def obs_residual(uv_est):
        return (prob.uv - uv_est) * ov[..., None]

    kv = (prob.knot_valid if prob.knot_valid is not None
          else torch.ones_like(prob.gaps))
    if prior is not None:
        if prior.valid.shape != (B, P, Nl):
            raise ValueError(f"prior laid out {tuple(prior.valid.shape)}, "
                             f"the problem {(B, P, Nl)}")
        p_fields = (prior.prop_states.reshape(BPN, 10),
                    prior.H_state.reshape(BPN, 6, 6),
                    prior.H_rot.reshape(BPN, 3, 3))
        p_valid = (prior.valid * kv).reshape(BPN)

    def prior_at(st):
        """The prior factor at states (..., B, P, Nl, 10): block-diagonal,
        so evaluated over the B·P·Nl knots flattened."""
        lead = st.shape[:-4]
        return factors.prior_factor(st.reshape(lead + (BPN, 10)), *p_fields,
                                    vel_coeff_prior, quat_coeff_prior,
                                    valid=p_valid)

    rp = factors.reprojection_factor(states.reshape(BPN, 10), lm_flat, ii,
                                     intr)
    r_obs = obs_residual(rp.uv.reshape(B, P, Nl, D, 2))
    Jg = rp.J.reshape(BPN, D, 2, 9)

    # robust scale: the distributed median of |r| (a mean scale is not
    # robust to gross outliers)
    c = torch.clamp(_distributed_median_abs(r_obs, ov[..., None] > 0,
                                            mesh=mesh),
                    min=1e-12).view(B, 1, 1, 1, 1)
    alpha, denom, sigma, sqrt_sigma = _schedule(sched_iter, dtype, params)
    if alpha >= 2.0 - 1e-9:
        w_el = torch.ones_like(r_obs) / (c * c)
    else:
        x2 = (r_obs / c) ** 2
        w_el = ((x2 / denom + 1.0) ** (alpha / 2.0 - 1.0)) / (c * c)
    w = w_el.mean(-1) * ov
    wmax = mesh_mod.pmax(w.amax((-2, -1)), dim=-1, mesh=mesh)  # (B, 1)
    w = w / torch.clamp(wmax, min=1e-30)[..., None, None] * conf * ov

    # --- dynamics factor with halo knot ------------------------------------
    dyn_on = 1.0 - float(initialize)
    halo = mesh_mod.halo_from_right(states[..., 0, :], dim=-2,
                                    mesh=mesh)  # (B, P, 10)
    states_ext = torch.cat([states, halo[..., None, :]], dim=-2)
    cum_ext = torch.cat([prob.cum_rot, prob.cum_rot[..., -1:, :]], dim=-2)
    gaps_ext = torch.cat([prob.gaps, torch.zeros_like(prob.gaps[..., :1])],
                         dim=-1)
    pv_ext = pv * dyn_on  # pair activity; zeroed in the vision-only init
    dyn = factors.dynamics_factor(
        states_ext, gaps_ext, cum_ext, qc, vc, valid_pair=pv_ext,
        num_hops=params.num_hops, max_substep=params.max_substep)
    # dyn.* index t in [0, Nl): pair (local t, local t+1 or halo)
    A, Bm = dyn.A, dyn.B
    At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
    res_pv = dyn.res_pv

    # --- normal equation blocks: kernel K2 over all B·P·Nl knots ----------
    G_obs, g_obs = assemble_normal_eq(
        Jg, r_obs.reshape(BPN, D, 2), w.reshape(BPN, D),
        f32=use_pallas_assembly)
    D_blk = G_obs.view(B, P, Nl, 9, 9) + sigma * (At @ A)
    D_blk = D_blk + sigma * dyn.Hq_diag[..., :-1, :, :]
    # the prior factor (block-diagonal: local to each knot)
    pf = None if prior is None else prior_at(states)
    if pf is not None:
        D_blk = D_blk + (pf.Jp.transpose(-1, -2) @ pf.Jp
                         + pf.Hq_diag).view(B, P, Nl, 9, 9)
    # BᵀB belongs to knot t+1: local for t < Nl-1, the right neighbour's
    # first knot for the boundary pair
    BtB = sigma * (Bt @ Bm)
    D_blk[..., 1:, :, :] += BtB[..., :-1, :, :]
    D_blk[..., 0, :, :] += mesh_mod.push_right(BtB[..., -1, :, :], dim=-3,
                                               mesh=mesh)
    # the halo knot's Hq_diag (from the boundary quaternion residual)
    D_blk[..., 0, :, :] += mesh_mod.push_right(
        sigma * dyn.Hq_diag[..., -1, :, :], dim=-3, mesh=mesh)
    U_blk = sigma * (At @ Bm + dyn.Hq_off)  # (B, P, Nl, 9, 9)

    # --- gradient -----------------------------------------------------------
    JfT_r = (At @ res_pv[..., None])[..., 0]
    BtR = (Bt @ res_pv[..., None])[..., 0]
    JfT_r[..., 1:, :] += BtR[..., :-1, :]
    JfT_r[..., 0, :] += mesh_mod.push_right(BtR[..., -1, :], dim=-2,
                                            mesh=mesh)
    qgrad = dyn.qgrad[..., :-1, :].clone()
    qgrad[..., 0, :] += mesh_mod.push_right(dyn.qgrad[..., -1, :], dim=-2,
                                            mesh=mesh)
    JTr = g_obs.view(B, P, Nl, 9) - sigma * JfT_r - sigma * qgrad
    if pf is not None:
        JTr = (JTr - (pf.Jp.transpose(-1, -2) @ pf.res[..., :6, None])[
            ..., 0].view(B, P, Nl, 9) - pf.qgrad.view(B, P, Nl, 9))

    # --- residual means (global over each orbit's shards) -------------------
    def psum(x):
        return mesh_mod.psum(x, dim=-1, mesh=mesh)

    # pred_dim 6 in the vision-only init, 7 otherwise (the quat residual)
    pred_dim = 7.0 if dyn_on > 0 else 6.0
    n_obs = psum(_local_sum(2.0 * ov, 2))
    if pf is not None:
        n_obs = n_obs + psum(7.0 * _local_sum(kv, 1))
    n_all = n_obs + psum(pred_dim * _local_sum(pv, 1))

    def global_mean_res(r_o, r_p, pf_=None):
        so = psum(_local_sum(r_o.abs() * ov[..., None], 3))
        if pf_ is not None:
            r_pri = pf_.res.view(pf_.res.shape[:-2] + (B, P, Nl, 7))
            so = so + psum(_local_sum(r_pri.abs() * kv[..., None], 2))
        sp = psum(_local_sum(r_p.abs() * sqrt_sigma, 2))
        return ((so + sp) / torch.clamp(n_all, min=1.0))[..., 0]

    r_pred_full = torch.cat([res_pv, dyn.res_q[..., None]], dim=-1)
    init_residual = global_mean_res(r_obs, r_pred_full, pf)  # (B,)

    eye = torch.eye(9, dtype=dtype, device=dev)

    def retract(dpose):
        position = states[..., :3] + dpose[..., 0:3]
        rotation = quat.box_plus(states[..., 3:7], dpose[..., 3:6])
        vels = states[..., 7:10] + dpose[..., 6:9]
        return torch.cat([position, rotation, vels], dim=-1)

    def trial_residual(states_new):
        uv_new = factors.project_landmarks(
            states_new.reshape(states_new.shape[:-4] + (BPN, 10)), lm_flat,
            ii, intr)
        r_o = obs_residual(uv_new.reshape(states_new.shape[:-4]
                                          + (B, P, Nl, D, 2)))
        halo1 = mesh_mod.halo_from_right(states_new[..., 0, :], dim=-2,
                                         mesh=mesh)
        st_ext = torch.cat([states_new, halo1[..., None, :]], dim=-2)
        d1 = factors.dynamics_factor(
            st_ext, gaps_ext, cum_ext, qc, vc, valid_pair=pv_ext,
            num_hops=params.num_hops, max_substep=params.max_substep,
            with_jacobian=False)
        r_p = torch.cat([d1.res_pv, d1.res_q[..., None]], dim=-1)
        return global_mean_res(r_o * w[..., None], r_p,
                               None if prior is None else prior_at(states_new))

    def solve_with(lamdas):
        # symmetric Jacobi scaling for f32 conditioning; the boundary U
        # needs the right neighbour's first scale vector (one more halo)
        Dl = D_blk + lamdas[..., None, None, None, None] * eye
        diag = torch.diagonal(Dl, dim1=-2, dim2=-1)
        s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
        s_halo = mesh_mod.halo_from_right(s[..., 0, :], dim=-2, mesh=mesh)
        s_next = torch.cat([s[..., 1:, :], s_halo[..., None, :]], dim=-2)
        Ds = Dl * s[..., :, None] * s[..., None, :]
        Us = U_blk * s[..., :, None] * s_next[..., None, :]
        x = _shard_body(Ds, Us, JTr * s, mesh)
        return retract(x * s)

    # the batched λ search: K static candidates by repeated products (bit
    # for bit the sequential loop's values); the first accepted, else the
    # last <= λ_max, as ba._lambda_search
    K = max(int(np.ceil(np.log(params.lambda_max / 1e-4)
                        / np.log(params.lambda_growth))) + 1, 2)
    lams = [lamda.to(dtype)]
    for _ in range(K - 1):
        lams.append(lams[-1] * params.lambda_growth)
    lamdas = torch.stack(lams)  # (K, B)
    states_c = solve_with(lamdas)  # (K, B, P, Nl, 10)
    trials = trial_residual(states_c)  # (K, B)
    ks = torch.arange(K, device=dev)[:, None]
    valid = (ks == 0) | (lamdas <= params.lambda_max)
    accepted = valid & (trials < init_residual)
    first_acc = torch.argmax(accepted.to(torch.int32), dim=0)
    last_valid = K - 1 - torch.argmax(valid.flip(0).to(torch.int32), dim=0)
    j = torch.where(accepted.any(0), first_acc, last_valid)  # (B,)
    lam_f = lamdas.gather(0, j[None])[0] * params.lambda_growth
    lam_next = torch.clamp(torch.clamp(lam_f * 0.01, max=1e-1), min=1e-4)
    states_new = torch.take_along_dim(
        states_c, j.view(1, B, 1, 1, 1), dim=0)[0]
    return states_new, lam_next, trials.gather(0, j[None])[0]


def own_shards(prob, mesh: mesh_mod.Mesh):
    """This process's shards of a ShardedProblem or ShardedPrior laid out
    over all of the mesh's n_arc shards (`mesh_mod.own_shards` of each knot
    array): the problem itself on one device."""
    return type(prob)(**{
        name: (v if v is None or name == "intrinsics"
               else mesh_mod.own_shards(v, dim=1, mesh=mesh))
        for name, v in prob._asdict().items()})


def _check_on_mesh(mesh: mesh_mod.Mesh, prob: ShardedProblem) -> None:
    if prob.states.shape[1] != mesh.local_arc:
        raise ValueError(f"problem has {prob.states.shape[1]} arc shards, "
                         f"the mesh {mesh.local_arc} in this process")
    if prob.states.device.type != mesh.device.type:
        raise ValueError(f"problem on {prob.states.device}, mesh on "
                         f"{mesh.device}")


def make_sharded_ba_step(mesh: mesh_mod.Mesh,
                         params: SolverParams = SolverParams(),
                         use_pallas_assembly: bool = False):
    """The sharded LM step: step(sched_iter, lamda (B,), prob,
    initialize=0.0) -> (new_states (B, P, Nl, 10), new_lamda (B,)).  P must
    be the mesh's arc shards in this process (`own_shards` of a problem
    over all of them); the problem lies on the mesh's device.
    use_pallas_assembly runs kernel K2 in f32 (the JAX flag's meaning)."""

    def step(sched_iter, lamda_b, prob: ShardedProblem, initialize=0.0):
        _check_on_mesh(mesh, prob)
        st, lam, _ = _one_orbit_iteration(
            sched_iter, lamda_b, prob, params, initialize=initialize,
            use_pallas_assembly=use_pallas_assembly, mesh=mesh)
        return st, lam

    return step


def make_sharded_window_solver(mesh: mesh_mod.Mesh,
                               params: SolverParams = SolverParams(),
                               num_iters: int = 20, init_iters: int = 0,
                               with_prior: bool = False,
                               quat_coeff_prior: float = 1.0,
                               vel_coeff_prior: float = 1.0):
    """A whole window's LM chain on the mesh (the sharded analog of
    window.solve_window / solve_window_reg):

      * params.max_iters <= num_iters: exactly num_iters iterations,
        returning the LAST iterate;
      * params.max_iters > num_iters: max_iters iterations, returning each
        orbit's BEST-residual iterate; the tracker resets when the
        vision-only init phase ends (i == init_iters).

    The first init_iters iterations are vision-only; the schedule index is
    the iteration.  with_prior adds the BA_reg prior factor; a solve called
    without a ShardedPrior then takes an all-invalid one (as the JAX solver
    builds it), and without with_prior a prior is ignored.  quat_coeff_prior
    / vel_coeff_prior weight the prior factor (factors.prior_factor).

    Returns solve(lamda0 (B,), prob, prior=None) -> (states (B, P, Nl, 10),
    lamda (B,), mean_residual (B,)).  P must be the mesh's arc shards in
    this process: a 1x1 mesh solves the window on one shard.  The chain is
    window._lm_loop's without its early stop (the JAX package's sharded
    chain has none)."""
    # conv_patience >= the extra budget turns _lm_loop's early stop off
    loop_params = params._replace(conv_patience=params.max_iters)

    def solve(lamda_b, prob: ShardedProblem,
              prior: Optional[ShardedPrior] = None):
        _check_on_mesh(mesh, prob)
        st = prob.states
        B, P, Nl = st.shape[:3]
        if not with_prior:
            prior = None
        elif prior is None:
            prop = st.new_zeros((B, P, Nl, 10))
            prop[..., 6] = 1.0  # identity quaternions
            prior = ShardedPrior(prop, st.new_zeros((B, P, Nl, 6, 6)),
                                 st.new_zeros((B, P, Nl, 3, 3)),
                                 st.new_zeros((B, P, Nl)))
        no_h = st.new_zeros((B, 9, 9))

        def step_i(i, states, lam):
            # _lm_loop's orbit axis leads (B, N, 10); the chain keeps no
            # Hessian
            st_n, lam_n, res = _one_orbit_iteration(
                i, lam, prob._replace(states=states.reshape(B, P, Nl, 10)),
                params, initialize=float(i < init_iters), prior=prior,
                mesh=mesh, quat_coeff_prior=quat_coeff_prior,
                vel_coeff_prior=vel_coeff_prior)
            return BAStep(st_n.reshape(B, P * Nl, 10), lam_n, no_h, res)

        st, lam, _, res = window._lm_loop(
            step_i, st.reshape(B, P * Nl, 10), lamda_b.to(st.dtype),
            init_iters, num_iters, loop_params)
        return st.reshape(B, P, Nl, 10), lam, res

    return solve

"""Patch-warp (photometric) BA (reference:
pixsfm/residuals/src/featuremetric.h:77-188 + patch_warp_bundle_optimizer.h:
21-61).

Port of ``pixsfm_tpu/bundle_adjustment/patch_warp.py``. Residual per
observation: project the 3D point into the *source* view (the track's
reference observation), offset the interpolation nodes by ``node /
source_scale`` in source pixels, lift each node to 3D at the source depth
(fronto-parallel, ``PixelToWorld``), reproject the lifted nodes into the
*target* view and read the target window there, one point per node
(``ops/interpolate_cuda.interpolate``: for BICUBIC kernel K1, one launch
for all nodes of a chunk, each on its observation's window row; the other
feature modes in plain PyTorch),
NCC-normalized across the nodes when the config asks, less the reference's
node descriptor, times the observation's validity ``v``; with
``check_bounds`` the summed node violation of the window's extent is one
more residual.

Two coupling modes, as in the JAX package: **joint** (``refine_extrinsics``
with ``optimizer.optimize_source_poses``, the default) makes the source
pose a second optimized block per observation (``BAObservations.src_idx``
of ``ops/schur.py``); **constant source** carries it per observation as a
constant (the shipped ``photometric`` preset, points only). Source
intrinsics are constants in both.

The Jacobian is closed form: K1's ``dfdr`` / ``dfdc`` through the NCC chain
rule, onto ``d(patch coords)/d(params)`` of the warp geometry, built from
``img_from_cam_with_jac`` (both views) and the implicit derivative of the
undistortion (the inverse of the distortion's 2x2 Jacobian at the
undistorted point), where the JAX package takes ``jax.jacfwd`` through its
Newton iterations. Padded rows are sanitized with ``where`` as in the JAX
package (a NaN would poison the sums); mixed camera models are evaluated in
groups of one (target model, source model) pair, where the JAX package
switches per observation; the per-observation bookkeeping is vectorised
and keeps the JAX package's order. The target windows stay in the packed
rows and are read by row.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import logger
from ..base.cameras import CAMERA_MODELS, cam_from_img, img_from_cam_with_jac
from ..base.geometry import apply_pose, quat_rotate, quat_to_rotmat
from ..base.interpolation import (InterpolationConfig, bounds_violation,
                                  check_window_config, ncc_normalize,
                                  ncc_normalize_with_grad)
from ..base.losses import make_loss
from ..features.featuremaps import FeatureView
from ..ops.interpolate_cuda import interpolate
from .references import extract_references

__all__ = ["patch_warp_ba", "build_patch_warp_residual",
           "build_patch_warp_residual_jac"]

_IDENTITY_Q = (1.0, 0.0, 0.0, 0.0)


def _skew(v):
    """``[..., 3] -> [..., 3, 3]``: ``skew(v) @ w == cross(v, w)``."""
    z = torch.zeros_like(v[..., 0])
    a, b, c = v.unbind(-1)
    return torch.stack([torch.stack([z, -c, b], -1),
                        torch.stack([c, z, -a], -1),
                        torch.stack([-b, a, z], -1)], -2)


def _perspective_jac(x, z):
    """``d (x[:2] / z) / d x`` ``[..., 2, 3]`` at camera points ``x`` with
    the guarded depth ``z``."""
    iz = 1.0 / z
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([iz, zero, -x[..., 0] * iz * iz], -1),
        torch.stack([zero, iz, -x[..., 1] * iz * iz], -1)], -2)


def _inv2x2(J):
    a, b, c, d = J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]


def _guard(z):
    """JAX's depth guard: 1 where ``|z| <= 1e-6``."""
    return torch.where(torch.abs(z) > 1e-6, z, torch.ones_like(z))


def _warp(tmodel, smodel, q, t, cam, sq, st, scam, sscale, X, nodes,
          with_jac: bool, joint: bool):
    """Target pixels ``[n, N, 2]`` of the ``N`` nodes warped from the source
    view (``warp_node`` of the JAX package), and with ``with_jac`` their
    Jacobian ``[n, N, 2, P]`` over ``[omega, dt, (omega_src, dt_src,)
    dcam(k), dX]``. ``cam`` / ``scam`` hold the target / source model's
    own parameters."""
    x_s = apply_pose(sq, st, X)                                   # [n, 3]
    depth = _guard(x_s[:, 2])
    uv_s = x_s[:, :2] / depth[:, None]
    xy_s, Jifc_s, _ = img_from_cam_with_jac(smodel, scam, uv_s)
    xy_n = xy_s[:, None] + nodes[None] / sscale[:, None]          # [n, N, 2]
    uvn = cam_from_img(smodel, scam[:, None], xy_n)
    x_cam_n = torch.cat([uvn * depth[:, None, None],
                         depth[:, None, None].expand(-1, uvn.shape[1], 1)],
                        dim=-1)
    y = x_cam_n - st[:, None]
    # the conjugate of the normalized source rotation; its norm summed in
    # float64 and rounded once, as XLA's fused reduction rounds it (NCC
    # scales a rounding step of the warped nodes by 1 / sigma)
    norm = torch.sqrt(torch.sum(sq.double() ** 2, -1, keepdim=True))
    qinv = torch.cat([sq[:, :1], -sq[:, 1:]], -1) / norm.to(sq.dtype)
    Xn = quat_rotate(qinv[:, None], y)                            # [n, N, 3]
    x_t = apply_pose(q[:, None], t[:, None], Xn)
    zt = _guard(x_t[..., 2])
    pix, Jifc_t, Jcam_t = img_from_cam_with_jac(
        tmodel, cam[:, None], x_t[..., :2] / zt[..., None])
    if not with_jac:
        return pix, None
    # target: d pix / d x_t, then the target pose, intrinsics and Xn
    Jt = Jifc_t @ _perspective_jac(x_t, zt)                       # [n,N,2,3]
    Rt = quat_to_rotmat(q)[:, None]                               # [n,1,3,3]
    J_wt = -Jt @ _skew(x_t - t[:, None])
    J_Xn = Jt @ Rt                                                # [n,N,2,3]
    # source: d x_cam_n / d x_s through the undistortion's implicit
    # derivative (the inverse of d xy / d uv at the undistorted node)
    An = _inv2x2(img_from_cam_with_jac(smodel, scam[:, None], uvn)[1])
    K = An @ (Jifc_s @ _perspective_jac(x_s, depth))[:, None]     # [n,N,2,3]
    zero = torch.zeros_like(K[..., :1, :])                       # [n,N,1,3]
    e3 = torch.cat([zero[..., :2], torch.ones_like(zero[..., 2:])], -1)
    G = torch.cat([depth[:, None, None, None] * K + uvn[..., None] * e3,
                   e3], dim=-2)                                   # [n,N,3,3]
    Rs = quat_to_rotmat(sq)[:, None]
    RsT = Rs.transpose(-1, -2)
    cols = [J_wt, Jt]
    if joint:
        # left perturbations: d x_s = -[R_s X]_x omega + dt, and
        # Xn = R_s^T (x_cam_n(x_s) - t_s) turns the rotation onto y too
        dXn_dw = RsT @ (_skew(y) - G @ _skew(x_s - st)[:, None])
        dXn_dt = RsT @ (G - torch.eye(3, dtype=G.dtype, device=G.device))
        cols += [J_Xn @ dXn_dw, J_Xn @ dXn_dt]
    cols += [Jcam_t, J_Xn @ (RsT @ G @ Rs)]
    return pix, torch.cat(cols, dim=-1)


def _sanitize(sq, scam, sscale):
    """JAX's operand sanitization of padded rows (``patch_warp.py:101-118``):
    an identity source quaternion, a unit-focal source camera and unit
    scales where the padding left zeros. The dummy camera's parameters 0
    and 1 are 1, so that a model with two focal lengths (PINHOLE, OPENCV,
    OPENCV_FISHEYE) gets ``fy = 1`` too; JAX's sets parameter 0 only, and
    its padded rows then divide by ``fy = 0`` (ROADMAP.md section 3)."""
    identity = torch.zeros_like(sq)
    identity[:, 0] = 1.0
    sq = torch.where((torch.sum(sq * sq, -1) > 1e-12)[:, None], sq, identity)
    dummy = torch.zeros_like(scam)
    dummy[:, :2] = 1.0
    scam = torch.where((torch.abs(scam[:, 0]) > 1e-8)[:, None], scam, dummy)
    sscale = torch.where(torch.abs(sscale) > 1e-8, sscale,
                         torch.ones_like(sscale))
    return sq, scam, sscale


def _warp_groups(model, mi, q, t, cam, sq, st, scam, sscale, X, nodes,
                 with_jac, joint):
    """:func:`_warp` over a chunk: one call for one camera model, else one
    per (target model, source model) pair present, scattered back in
    order (``cam`` / ``scam`` padded to the widest model)."""
    if mi is None:
        return _warp(model, model, q, t, cam, sq, st, scam, sscale, X,
                     nodes, with_jac, joint)
    from .main import _model_groups
    tmi, smi = mi
    nm = len(model)
    n, N, k = X.shape[0], nodes.shape[0], cam.shape[-1]
    pix = X.new_empty((n, N, 2))
    J = X.new_zeros((n, N, 2, (12 if joint else 6) + k + 3)) \
        if with_jac else None
    for pair, idx in _model_groups(tmi * nm + smi, nm * nm):
        tm, sm = model[pair // nm], model[pair % nm]
        kt, ks = CAMERA_MODELS[tm].num_params, CAMERA_MODELS[sm].num_params
        p, Jg = _warp(tm, sm, q[idx], t[idx], cam[idx, :kt], sq[idx],
                      st[idx], scam[idx, :ks], sscale[idx], X[idx], nodes,
                      with_jac, joint)
        pix[idx] = p
        if with_jac:
            c0 = 12 if joint else 6
            J[idx, :, :, :c0 + kt] = Jg[..., :c0 + kt]
            J[idx, :, :, c0 + k:] = Jg[..., c0 + kt:]
    return pix, J


def _residual(interp: InterpolationConfig, model, joint: bool, with_jac,
              nodes, q, t, sq, st, cam, X, obs, ctx):
    """The patch-warp residual ``[n, N*C (+1)]`` (and its Jacobian ``[n,
    N*C (+1), P]``) of a chunk. ``nodes [N, 2]`` on the chunk's device;
    ``obs``: ``(row, scam, sscale, target, v[, tmi, smi])`` with the source
    pose given separately."""
    row, scam, sscale, target, v = obs[:5]
    mi = (obs[5], obs[6]) if isinstance(model, tuple) else None
    sq, scam, sscale = _sanitize(sq, scam, sscale)
    N = nodes.shape[0]
    pix, Jpix = _warp_groups(model, mi, q, t, cam, sq, st, scam, sscale, X,
                             nodes, with_jac, joint)
    # patch coordinates of the target window (sanitized scales, as JAX)
    sc, up = ctx.scales[row], ctx.ups[row]
    sc = torch.where(torch.abs(sc) > 1e-8, sc, torch.ones_like(sc))
    up = torch.where(torch.abs(up) > 1e-8, up, torch.ones_like(up))
    su = (sc * up[:, None])[:, None]                              # [n, 1, 2]
    pc = (pix * sc[:, None] - 0.5 - ctx.corners[row][:, None]) \
        * up[:, None, None]
    # one point read at every warped node of each observation's target
    # window (for BICUBIC one K1 launch, N queries on the observation's row)
    n = row.shape[0]
    single = InterpolationConfig(mode=interp.mode,
                                 l2_normalize=interp.l2_normalize)
    f, dfdr, dfdc = (a.reshape(n, N, -1) for a in interpolate(
        ctx.rows, ctx.H, ctx.W, ctx.C, (row * ctx.H).repeat_interleave(N),
        pc[..., 1].reshape(-1), pc[..., 0].reshape(-1), single))
    C = f.shape[-1]
    if with_jac:
        Jpc = su[..., None] * Jpix                                # [n,N,2,P]
        Jf = (dfdc[:, None] * Jpc[:, :, 0].transpose(1, 2)[..., None]
              + dfdr[:, None] * Jpc[:, :, 1].transpose(1, 2)[..., None])
    if interp.ncc_normalize:
        if with_jac:
            g, (Jf,) = ncc_normalize_with_grad(f[:, None], (Jf,))
            f = g[:, 0]
        else:
            f = ncc_normalize(f)
    r = f.reshape(n, N * C) - target
    if with_jac:
        J = Jf.permute(0, 2, 3, 1).reshape(n, N * C, -1)
    if interp.check_bounds:
        rr, cc = pc[..., 1], pc[..., 0]
        r = torch.cat([r, bounds_violation(rr, cc, ctx.H, ctx.W)
                       .sum(1, keepdim=True)], dim=1)
        if with_jac:
            dv_dr = (rr > ctx.H - 1.0).float() - (rr < 0.0).float()
            dv_dc = (cc > ctx.W - 1.0).float() - (cc < 0.0).float()
            Jv = (dv_dc[..., None] * Jpc[:, :, 0]
                  + dv_dr[..., None] * Jpc[:, :, 1]).sum(1)
            J = torch.cat([J, Jv[:, None]], dim=1)
    r = r * v[:, None]
    if not with_jac:
        return r
    return r, J * v[:, None, None]


def _split(joint: bool, args):
    """``(q, t, sq, st, cam, X, obs)`` from the solver's arguments: joint
    ``(q, t, q_src, t_src, cam, X, obs_slice, ctx)``, constant ``(q, t,
    cam, X, obs_slice, ctx)`` with the source pose in ``obs_slice``."""
    if joint:
        return args[:6], args[6]
    q, t, cam, X, (row, sq, st, *rest) = args[:5]
    return (q, t, sq, st, cam, X), (row, *rest)


def _build(model, interp: InterpolationConfig, joint: bool, with_jac: bool):
    nodes = {}       # per device, copied once: a copy from pageable host
                     # memory would wait for the device at every chunk

    def fn(*args):
        (q, t, sq, st, cam, X), obs = _split(joint, args[:-1])
        if X.device not in nodes:
            nodes[X.device] = torch.as_tensor(interp.nodes_array(),
                                              device=X.device)
        return _residual(interp, model, joint, with_jac, nodes[X.device], q,
                         t, sq, st, cam, X, obs, args[-1])
    return fn


def build_patch_warp_residual(model, interp: InterpolationConfig,
                              joint: bool):
    """The residual function of :func:`ops.schur.ba_solve`: ``(q, t,
    [q_src, t_src,] cam, X, obs_slice, ctx) -> r``. ``obs_slice``: joint
    ``(row, src_cam, src_scale, target, v[, tgt_mi, src_mi])``, constant
    ``(row, src_q, src_t, src_cam, src_scale, target, v[, ...])``;
    ``ctx`` the packed target windows (``main._PatchRows``)."""
    return _build(model, interp, joint, False)


def build_patch_warp_residual_jac(model, interp: InterpolationConfig,
                                  joint: bool):
    """:func:`build_patch_warp_residual` with its Jacobian ``[n, D, P]``
    over ``[omega, dt, (omega_src, dt_src,) dcam(k), dX]``."""
    return _build(model, interp, joint, True)


def patch_warp_ba(adjuster, reconstruction, feature_set,
                  problem_setup=None) -> Dict:
    """Patch-warp BA of ``reconstruction`` in place (``patch_warp_ba`` of
    the JAX package); its summary adds ``num_residuals``,
    ``joint_source_poses`` and ``references_time``."""
    from .main import _PatchRows, window_obs_data

    conf = adjuster.conf
    interp = InterpolationConfig.from_conf(conf.get("interpolation"))
    if interp.n_nodes < 2:
        raise ValueError("patch_warp BA needs n_nodes > 1 interpolation "
                         "nodes")
    check_window_config(interp)
    loss = make_loss(conf.optimizer.get("loss"))
    opts = adjuster._ba_options()
    flags = adjuster._optimizer_flags()
    joint = bool(conf.optimizer.get("optimize_source_poses", True)) \
        and flags["refine_extrinsics"]

    packed, model, tmi = adjuster._pack(reconstruction, problem_setup)
    view = FeatureView.from_reconstruction(feature_set, reconstruction,
                                           packed.point_ids)
    pf = view.packed
    t_ref = time.time()
    ref_conf = dict(conf.references.to_dict()
                    if hasattr(conf.references, "to_dict")
                    else conf.references)
    refs = extract_references(reconstruction, feature_set, view, ref_conf,
                              interp, point3D_ids=packed.point_ids)
    t_ref = time.time() - t_ref

    # per point: its reference's source view and descriptor
    Np, O = len(packed.point_ids), len(packed.obs_img)
    D = interp.n_nodes * pf.channels
    has_ref = np.zeros(Np, bool)
    src_iid = np.zeros(Np, np.int64)
    src_scale_p = np.ones((Np, 2))
    desc = np.zeros((Np, D), np.float32)
    for s, pid in enumerate(packed.point_ids):
        ref = refs.get(int(pid))
        if ref is None:
            continue
        has_ref[s] = True
        src_iid[s] = ref.source[0]
        src_scale_p[s] = pf.scales[pf.row_or(
            reconstruction.images[ref.source[0]].name, ref.source[1])]
        desc[s] = ref.descriptor
    names = {iid: im.name for iid, im in reconstruction.images.items()}
    rows = np.full(O, -1, np.int64)
    for iid in np.unique(packed.obs_image_id):
        idx = np.nonzero(packed.obs_image_id == iid)[0]
        rows[idx] = pf.rows_or_for_image(names[int(iid)],
                                         packed.obs_p2D_idx[idx])
    valid = has_ref[packed.obs_pt] & (rows >= 0)

    # per observation: the source view's constants (defaults where invalid,
    # as the JAX package fills them)
    slot_of_image = {int(i): s for s, i in enumerate(packed.image_ids)}
    cam_slot = {int(c): s for s, c in enumerate(packed.camera_ids)}
    src_of_obs = src_iid[packed.obs_pt]
    img_slot = np.asarray([slot_of_image.get(int(i), -1)
                           for i in src_iid])[packed.obs_pt]
    src_cam_slot = np.asarray([cam_slot[reconstruction.images[int(i)]
                                        .camera_id] if h else 0
                               for i, h in zip(src_iid, has_ref)]
                              )[packed.obs_pt]
    qs = np.stack([reconstruction.images[int(i)].qvec if h
                   else _IDENTITY_Q for i, h in zip(src_iid, has_ref)])
    ts = np.stack([reconstruction.images[int(i)].tvec if h else np.zeros(3)
                   for i, h in zip(src_iid, has_ref)])
    v = valid[:, None]
    src_q = np.where(v, qs[packed.obs_pt], _IDENTITY_Q).astype(np.float32)
    src_t = np.where(v, ts[packed.obs_pt], 0.0).astype(np.float32)
    src_cam = np.where(v, packed.cams[src_cam_slot],
                       packed.cams[packed.obs_cam]).astype(np.float32)
    src_mi = np.where(valid, packed.cam_model_idx[src_cam_slot],
                      packed.cam_model_idx[packed.obs_cam]).astype(np.int64)
    src_scale = np.where(v, src_scale_p[packed.obs_pt], 1.0) \
        .astype(np.float32)
    targets = np.where(v, desc[packed.obs_pt], 0.0).astype(np.float32)
    if joint and (img_slot[valid] < 0).any():
        # the source view outside a partial problem: every source pose
        # becomes constant
        logger.warning(
            "patch_warp: source image %d not in the problem; treating all "
            "source poses as constant.",
            int(src_of_obs[valid][img_slot[valid] < 0][0]))
        joint = False
    src_idx = np.where(valid, img_slot, 0) if joint else None

    rows = np.where(valid, rows, 0)
    src = () if joint else (src_q, src_t)
    obs_data = (rows, *src, src_cam, src_scale, targets,
                valid.astype(np.float32))
    if tmi is not None:
        obs_data += (tmi, src_mi)
    key, ctx = "patch_warp", _PatchRows(pf, adjuster.device)
    if adjuster._parallel_mesh() is not None:
        # the target windows travel with their observations' shards
        key, ctx = key + "_window", ()
        obs_data = window_obs_data(pf, rows, obs_data)
    out = adjuster._run_ba_cached(
        reconstruction, packed, (key, model, interp, joint), obs_data, ctx,
        loss, opts, obs_valid=valid, src_idx=src_idx)
    out["num_residuals"] = int(valid.sum())
    out["joint_source_poses"] = joint
    out["references_time"] = t_ref
    return out

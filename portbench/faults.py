"""The control and the planted faults of the comparison.

``plant(name, cell)`` arranges, before the cell's set-up, for the
timed path to be broken underneath as ``name`` says; the run then goes on
as a measured run does, and its comparison must come out false:

- ``control``: the program's S2DNet forward in TF32 (cuDNN and cuBLAS),
  the nearest precision below the configuration's float32 with TF32 off;
- ``<stage>_unchanged``: the stage returns its input state unchanged;
- ``<stage>_half``: the stage's answers for half of its batch (points)
  are left out, its input kept in their place;
- ``ba_points_only``: bundle adjustment runs with every pose and camera
  parameter held at its input and refines the points alone;
- ``features_altered``: every stored feature map has its channels rolled
  by one where the extractor produces it.

``FAULTS`` lists the faults each entry can have.
"""

from __future__ import annotations

import contextlib


FAULTS = {
    "run_ba": ("ba_unchanged", "ba_half", "ba_points_only",
               "features_altered"),
}


def plant(name: str, drv):
    if name == "none":
        return
    if name == "control":
        _tf32_extraction()
        return
    drv.plants.append(lambda d: HOOKS[name](d))


_SAVED = {}


def unplant():
    """Undo the control (the faults go with the tracer's wraps)."""
    if "no_tf32" in _SAVED:
        from pixsfm_tpu_torch.features.models import s2dnet
        s2dnet._no_tf32 = _SAVED.pop("no_tf32")


def _tf32_extraction():
    from pixsfm_tpu_torch.features.models import s2dnet
    _SAVED.setdefault("no_tf32", s2dnet._no_tf32)

    @contextlib.contextmanager
    def tf32():
        import torch
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved

    s2dnet._no_tf32 = tf32


def _keep_reconstruction(d, share):
    def before(rec, *a, **kw):
        d._saved = ({i: (im.qvec.copy(), im.tvec.copy())
                     for i, im in rec.images.items()},
                    {c: cam.params.copy() for c, cam in rec.cameras.items()},
                    {p: pt.xyz.copy() for p, pt in rec.points3D.items()})

    def after(out, rec, *a, **kw):
        poses, params, xyz = d._saved
        pids = sorted(xyz)
        keep = set(pids[:int(round(share * len(pids)))])
        for p in keep:
            rec.points3D[p].xyz = xyz[p]
        if share >= 1.0:
            for i, (q, t) in poses.items():
                rec.images[i].qvec, rec.images[i].tvec = q, t
            for c, prm in params.items():
                rec.cameras[c].params = prm
    d.tracer.wrap(d.sfm.bundle_adjuster, "refine_multilevel",
                  before=before, after=after)


def _points_only(d):
    opt = d.sfm.bundle_adjuster.conf.optimizer
    keys = ("refine_extrinsics", "refine_focal_length",
            "refine_principal_point", "refine_extra_params")

    def before(*a, **kw):
        d._flags = {k: opt[k] for k in keys}
        for k in keys:
            opt[k] = False

    def after(out, *a, **kw):
        for k, v in d._flags.items():
            opt[k] = v
    d.tracer.wrap(d.sfm.bundle_adjuster, "refine_multilevel",
                  before=before, after=after)


def _features_altered(d):
    ext = d.sfm.extractor.inner

    def after(fm, *a, **kw):
        import torch
        fm.patches.copy_(torch.roll(fm.patches, 1, dims=-1))
    d.tracer.wrap(ext, "_to_fmap", after=after)


HOOKS = {
    "ba_unchanged": lambda d: _keep_reconstruction(d, 1.0),
    "ba_half": lambda d: _keep_reconstruction(d, 0.5),
    "ba_points_only": _points_only,
    "features_altered": _features_altered,
}

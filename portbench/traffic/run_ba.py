"""Traffic of ``run_ba`` cells: ``refine_colmap.PixSfM.run_ba`` on a copy of
the configuration's perturbed reconstruction, one scene a job, back to
back (features at the reprojections, references, the BA solve).

The warm-up job runs the same shapes with the LM cut to one iteration.
The comparison after the window reads the last job's answers: the stored
feature windows at sampled observations (``feat_flip``) and every leaf BA
frees, by first-order optimality of the BA objective as the reference
evaluates it: the points (``ba_grad``), the poses (``pose_grad``) and the
camera parameters (``cam_grad``).
"""

from __future__ import annotations

import numpy as np

from portbench import sut
from portbench.reference import judge
from portbench.scenes import program as scene_program
from portbench.scenes.synthetic import make_scene
from portbench.weights import s2dnet_weights


class Traffic:
    unit = "scenes"

    def __init__(self, config, workload, seed, device, tracer):
        self.config, self.wl, self.seed = config, workload, int(seed)
        self.device, self.tracer = device, tracer
        self.params = workload.get("traffic", {})
        self.plants = []

    def setup(self):
        from pixsfm_tpu_torch.refine_colmap import PixSfM
        self.scene = make_scene(seed=self.seed, device=self.device,
                                **self.config["scene"])
        self.images = self.scene.views
        self.rec0 = scene_program.reconstruction(self.scene,
                                                 seed=self.seed + 1)
        self.weights = s2dnet_weights(self.seed, self.device)
        self.sfm = PixSfM(sut.program_conf(self.config), device=self.device)
        sut.load_weights(self.sfm.extractor.model, self.weights)
        by_id = {id(v): k for k, v in self.images.items()}
        self.sampled = sut.sample_views(self.scene.names,
                                        self.params.get("sample_views", 2),
                                        self.seed + 7)
        self.sfm.extractor = sut.RecordingExtractor(
            self.sfm.extractor, self.tracer, lambda im: by_id.get(id(im)),
            self.sampled, self.seed + 11)
        self.tracer.wrap(self.sfm.bundle_adjuster, "refine_multilevel",
                         span="ba")
        for hook in self.plants:
            hook(self)
        solver = self.sfm.bundle_adjuster.conf.optimizer.solver
        cap = solver.max_num_iterations
        solver.max_num_iterations = 1
        self.job()                                    # warm-up
        solver.max_num_iterations = cap
        self.sfm.extractor.recording = True

    def job(self):
        self.sfm.extractor.kept.clear()
        rec = self.rec0.copy()
        out = self.sfm.run_ba(rec, self.images)
        self.tracer.count("ba_cg_steps", sut.summary_total(out,
                                                           "cg_iterations"))
        self.last = rec
        return 1, 0

    def collect(self):
        """The last job's answers, copied off the program."""
        rec = self.last
        self.answers = dict(
            poses={im.name: (im.qvec.copy(), im.tvec.copy())
                   for im in rec.images.values()},
            params=next(iter(rec.cameras.values())).params.copy(),
            xyz={pid: p.xyz.copy() for pid, p in rec.points3D.items()},
            kept={k: (v[0], v[1].cpu()) for k, v in
                  self.sfm.extractor.kept.items()})

    def release(self):
        self.collect()
        del self.sfm, self.last
        sut.free_cuda()

    def check(self):
        a, sc, rec0 = self.answers, self.scene, self.rec0
        ps = int(self.config.get("patch_size", 16))
        out = {}
        out["feat_flip"], _ = judge.window_flips(
            self.weights, self.images,
            [(n, k, p) for (n, _), (k, p) in a["kept"].items()], ps)
        pids = sorted(rec0.points3D)
        row = {pid: i for i, pid in enumerate(pids)}
        obs = {}
        for im in rec0.images.values():
            obs[im.name] = np.asarray([row[p] for p in im.point3D_ids
                                       if p in row], np.int64)
        X0 = np.stack([rec0.points3D[p].xyz for p in pids])
        X1 = np.stack([a["xyz"][p] for p in pids])
        poses0 = {im.name: (im.qvec, im.tvec) for im in rec0.images.values()}
        # the gauge of pixsfm's default problem set-up: the first view's
        # pose and the second view's translation along x are held
        order = [rec0.images[i].name for i in sorted(rec0.images)]
        out.update(judge.ba_grad_ratios(
            self.weights, self.images, (sc.model, sc.params), obs, poses0,
            a["poses"], X0, X1, self.config["objective"]["ba"],
            params_after=a["params"],
            free_params=self.config.get("ba_free_params", ()),
            fixed_pose=order[0], fixed_tvec=(order[1], (0,))))
        return out

    def cleanup(self):
        pass

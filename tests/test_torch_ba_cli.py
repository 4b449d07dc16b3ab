"""The BA entry points on the CPU: ``PixSfM.run_ba`` and the
``bundle_adjuster`` command of ``refine_colmap`` on a 6-view 640x480
synthetic model that takes the CG path (moved out of
``tests/test_torch_ba.py`` so that the test suite's workers share the long
tests; torch keeps its default threads here: the S2DNet convolutions use
them)."""

import numpy as np

from pixsfm_tpu.sfm.model import Reconstruction as JRec
from pixsfm_tpu_torch.sfm.synthetic import \
    synthetic_reconstruction as t_synth


def _write_ba_scene(tmp_path):
    """A 6-view 640x480 synthetic model (639 points seen in every view, so
    the default config takes the CG path: 22 835 track pairs > 20 000) with
    perturbed points, plus smooth random images to extract features from."""
    import PIL.Image
    rec = t_synth(n_images=6, n_points=640, noise_px=0.0, seed=4,
                  width=640, height=480)
    rng = np.random.default_rng(4)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.01, 3)
    for im in rec.images.values():
        img = rng.integers(0, 255, (60, 80, 3)).astype(np.uint8)
        PIL.Image.fromarray(img).resize((640, 480), PIL.Image.BICUBIC) \
            .save(tmp_path / im.name)
    rec.write_binary(tmp_path / "model")
    return rec


def test_run_ba_and_cli_on_cpu(tmp_path):
    from pixsfm_tpu_torch.refine_colmap import PixSfM, main
    rec = _write_ba_scene(tmp_path)
    conf = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": 4}}}}}
    out = PixSfM(conf, device="cpu").run_ba(rec, tmp_path)
    assert out["obs_grid_T"] == [0] and out["iterations"][0] >= 1
    assert out["final_cost"][0] < out["initial_cost"][0]
    assert out["cg_iterations"][0] > 0
    main(["bundle_adjuster", "--input_path", str(tmp_path / "model"),
          "--output_path", str(tmp_path / "out"), "--image_dir",
          str(tmp_path), "--device", "cpu",
          "mapping.BA.optimizer.solver.max_num_iterations=2"])
    before, after = JRec.read(tmp_path / "model"), JRec.read(tmp_path / "out")
    assert after.points3D.keys() == before.points3D.keys()
    moved = [np.linalg.norm(after.points3D[p].xyz - q.xyz)
             for p, q in before.points3D.items()]
    assert np.isfinite(moved).all() and 0 < max(moved) < 0.5

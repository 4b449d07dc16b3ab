"""ETH3D evaluation configuration (reference: pixsfm/eval/eth3d/config.py).

A copy of ``pixsfm_tpu/eval/eth3d/config.py``: the scene and method
matrices and thresholds match the reference, so result tables are
comparable with the README numbers (BASELINE.md)."""

SCENES_INDOOR = ["delivery_area", "kicker", "office", "pipes", "relief",
                 "relief_2", "terrains"]
SCENES_OUTDOOR = ["courtyard", "electro", "facade", "meadow", "playground",
                  "terrace"]
SCENES = SCENES_INDOOR + SCENES_OUTDOOR

# keypoint detectors/matchers: sift needs OpenCV; the learned detectors
# (superpoint/r2d2/d2net, features/models/) need their public checkpoints
# for matching quality. The reference's method matrix (config.py:30-137,
# incl. d2-net at :81-89); DEFAULT_FEATURES there is sift/superpoint/r2d2.
METHODS = ["sift", "superpoint", "r2d2"]
EXTRA_METHODS = ["d2net", "loftr"]  # loftr is detector-free (semi-dense)

# triangulation tolerances in meters (reference triangulation.py:181-182)
TRIANGULATION_TOLERANCES = [0.01, 0.02, 0.05]

# localization AUC thresholds in meters (reference README.md:383)
LOCALIZATION_THRESHOLDS = [0.001, 0.01, 0.1]

# leave-N-out localization protocol (reference config.py:142-299)
NUM_HOLDOUT_IMAGES = 10

DOWNLOAD_URL = "https://www.eth3d.net/data/"  # zero-egress: must be pre-fetched

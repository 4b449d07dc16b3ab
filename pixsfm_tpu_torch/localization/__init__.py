"""Query localization (port of ``pixsfm_tpu/localization``): QKA -> RANSAC
PnP -> QBA, and the PnP that the incremental mapper calls."""

from .main import (  # noqa: F401
    QueryBundleAdjuster, QueryKeypointAdjuster, QueryLocalizer,
    compute_reprojection_errors, find_nearest_references,
    find_unique_inliers, find_unique_min_reproj_inliers,
)
from .pnp import (absolute_pose_estimation,  # noqa: F401
                  absolute_pose_estimation_batch, pose_refinement)

"""Absolute pose estimation (port of ``pixsfm_tpu/localization``; only the
PnP that the incremental mapper calls is ported so far)."""

from .pnp import (absolute_pose_estimation,  # noqa: F401
                  absolute_pose_estimation_batch)

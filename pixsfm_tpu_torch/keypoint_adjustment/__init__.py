"""Keypoint adjustment (port of ``pixsfm_tpu/keypoint_adjustment``)."""

from .main import (  # noqa: F401
    FeatureMetricKeypointAdjuster, KeypointAdjuster, KeypointAdjustmentSetup,
    TopologicalReferenceKeypointAdjuster, build_matching_graph,
    extract_patchdata_from_graph, find_problem_labels,
)

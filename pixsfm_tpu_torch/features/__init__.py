"""Feature containers, extractor and models (port of ``pixsfm_tpu/features``)."""

from .featuremaps import (  # noqa: F401
    DeviceFeatureMap, FeatureManager, FeatureMap, FeaturePatch, FeatureSet,
    FeatureView, PackedFeatures, kDensePatchId,
)

"""Feature containers, extractor and models (port of ``pixsfm_tpu/features``)."""

"""Host-side utilities (copies of ``pixsfm_tpu/util`` modules)."""

"""Evaluation harnesses (port of ``pixsfm_tpu/eval``)."""

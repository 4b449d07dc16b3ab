"""ETH3D triangulation and localization harnesses (port of
``pixsfm_tpu/eval/eth3d``)."""

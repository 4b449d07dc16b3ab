#!/usr/bin/env python3
"""Smoke run of pixsfm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out DIR]

Phases (any failure exits non-zero; no phase catches its own failure):

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build every CUDA kernel from ``pixsfm_tpu_torch/kernels/csrc``
   (one nvcc per source, all at once).
2. K1 (bicubic window interpolation, ``ops/interpolate_cuda.py``) against its
   plain PyTorch version on the card at the main path's shapes, bf16 and f32
   storage, L2 on and off, queries on the patch border; then at small shapes
   that reach its general variant and the edges of the vector one (channel
   counts that are no multiple of 8, f32 rows of 128 channels, 3 x 3
   patches, a base that is not 16-byte aligned); then at VGGNet's widths
   (phase 21(d)) at the KA shape, bf16 and f32, L2 on and off: 64 channels
   (general variant), 256 and 512 (vector variant), each also timed
   through the general variant.
3. K2 (batched Jacobi PCG, ``ops/cg_cuda.py``) against its plain version,
   folded-damping and explicit forms, each variant (register, general) at
   the main path's shape (P = 128 systems of N = 112, 15 steps) and at
   edge shapes (P = 300 and 1, 0 and 1 steps, N = 128, 51, 132 and 200);
   the main shape must take the register variant. Timed there on a
   repeated H, on 20 H sets that change from launch to launch, through the
   general variant (the earlier design), and with no CG step (load and set-up).
4. A small scene through ``PixSfM.run_ka`` on ``cuda`` and on ``cpu`` (the
   plain versions): the refined keypoints agree.
5. The main path at full width: ``PixSfM.run_ka`` with the default config
   (S2DNet 128 channels, bf16 patches of 16 px, 50 keypoints per problem,
   chunks of 128, 100 LM iterations) on 10 synthetic 1600x1200 views of one
   textured plane, 2000 points seen in every view. The kernel launch
   counters are zeroed just before and read just after; both kernels must
   have launched, the KA cost must fall, keypoints stay finite and within
   the bound.
6. Where the time goes: the same scene again, graph building, extraction
   and KA timed apart, the last two under ``torch.profiler`` (device-busy
   time and the top kernels; with ``--profile-out DIR`` the full tables go
   to ``DIR/chip_smoke_profile.txt``). K2 must show its register variant
   only.
7. K3a/b/c (the Schur kernels of the grid-regime CG solve,
   ``ops/schur_cuda.py``) against their plain versions at the BA main
   path's shape (T = 8 ranks, SIMPLE_RADIAL so k = 4, 56 images, one
   camera, 65 536 padded points): error against a float64 reference and
   time per launch, K3b also forced to its one-pass variant; then at small
   shapes that reach every variant of K3a and of K3b (fused with one and
   two ranks per warp, two-pass / one-pass, tables in shared and in global
   memory; T not a power of two, k = 1 and 8, mixed camera slots).
   Then K1 again at the BA path's shape: 8192 queries (one
   chunk of observations) over 240 000 bf16 patches (one per observation,
   7.9e9 elements, so offsets past 2^31), L2 on and off.
8. A small scene through ``ba_solve`` on the grid layout on ``cuda`` and
   on ``cpu`` (the plain versions): final cost and points agree.
9. The second main path at full size: ``PixSfM.run_ba`` with the default
   config (featuremetric BA, S2DNet 128 channels, bf16 patches) on 56
   rendered 1600x1200 views of a textured plane, 40 000 points with tracks
   of 4-8 views (~240 000 observations), poses and points perturbed from
   the truth. The scene's size makes ``_run_ba_cached`` pick the grid
   regime by itself; the LM runs at most ``BA_ITERATIONS`` iterations. The
   counters are zeroed just before and read just after: K1 and K3a/b/c
   must have launched, the cost must fall, poses and points stay finite.
10. Where the BA time goes: the same BA again, extraction and references +
   solve (``BA_PROFILE_ITERATIONS`` LM iterations) under ``torch.profiler``:
   device-busy time, idle share, the top kernels and the in-situ time per
   launch of K1 and K3a/b/c (a kernel that launched and has no in-situ
   figure fails the run). K3b must show its fused variant only.
11. The triangulation main path at full width: the body of
   ``PixSfM.triangulation`` (KA -> triangulation with known poses -> BA,
   default config, BA capped at ``BA_ITERATIONS``) on 24 rendered
   1600x1200 views, 8000 points with tracks of 3-8 views, keypoints the
   true projections plus N(0, 1 px), matches over every view pair within
   each track (score 1), the true poses and intrinsics as the reference
   model (written and read back). Counters zeroed just before and read
   just after: K1 and K2 must have launched, the BA must take the flat CG
   layout and lower its cost, the points stay finite and at least
   ``TRI_MIN_SURVIVING`` of the tracks survive. Then the same path under
   the profiler (BA capped at ``BA_PROFILE_ITERATIONS``), and K1 timed at
   this path's BA shape.
12. The dense Schur step: a small rendered scene (12 views of 640x480,
   1500 points with tracks of 3: 13 500 track pairs, 76 camera unknowns)
   through ``refine_reconstruction`` (the ``bundle_adjuster`` command's
   function, geometric strategy) on ``cuda`` and on ``cpu``, with one
   camera model and with two (half the views on PINHOLE): both must take
   the dense step and agree within phase 8's limits.
13. ``refine_colmap``'s ``keypoint_adjuster`` command on a COLMAP database
   of phase 5's scene (written with the port's ``COLMAPDatabase``): the
   keypoints it writes agree with ``run_ka`` on the same inputs within
   ``DB_KP_ATOL``.
14. PnP (``localization/pnp.py``): ``PNP_QUERIES`` queries of 30-2000
   correspondences (general and planar scenes, 0-60 % outliers,
   SIMPLE_RADIAL and PINHOLE) through ``absolute_pose_estimation_batch`` on
   ``cuda`` and on ``cpu``, unpolished and polished: the same success,
   inlier counts within 1, each pose explains all but one of the other's
   inliers, poses within ``PNP_UNPOLISHED_TOL`` / ``PNP_POLISHED_TOL``
   (tied hypotheses; see the constants). Then one stage-1 program and one stage-2 program
   timed, with their kernel launches counted under the profiler.
15. The incremental mapper (``sfm/mapper.py``) on the ring of
   ``tests/test_mapper_scale.py`` at 12 views and 300 points (unknown
   intrinsics) on ``cuda`` and on ``cpu``: the same registered images and
   initial pair, point counts within 2 %, and after a similarity alignment
   rotations within 0.05 degrees and centres within 1e-3 of the extent.
16. The reconstruction main path at full width: the body of
   ``PixSfM.reconstruction`` (KA -> incremental mapper with unknown
   intrinsics -> BA, default config, BA capped at ``BA_ITERATIONS``, the
   mapper at its defaults) on 24 ray-cast 1600x1200 views of a valley of two
   textured planes, ``RECON_POINTS`` points with tracks of 3-8 views,
   keypoints the true projections plus N(0, ``RECON_NOISE_PX``), matches
   over every view pair within each track. Counters zeroed just before and
   read just after: at least 23 of the 24 views register, after a
   similarity to the truth rotations within 0.5 degrees and centres within
   1 % of the extent, the BA cost falls, K1 and K2 launched. Then the KA
   and the final BA (capped at ``BA_PROFILE_ITERATIONS``) under the
   profiler, and one call of each of the mapper's device stages (PnP, the
   retriangulation, a geometric BA) on the final map, from which the
   mapper's device-idle share is estimated; and K1 timed at this path's BA
   shape.
17. Phase 11's triangulation path again with ``configs/dsift.yaml`` (dense
   SIFT, no weights): the point error to the truth before and after KA and
   BA beside S2DNet's; costs fall, points stay finite.
18. Query localization at full width: phase 16's valley seen by 32 ray-cast
   1600x1200 views; 24 at their true poses form the model (``RECON_POINTS``
   points, keypoints N(0, 0.5 px)), 8 are held-out queries (keypoints
   N(0, 1 px)) matched to their ``LOC_PAIRS`` nearest model views, with
   ``LOC_WRONG`` of the matches pointed at wrong points; the default
   ``localization`` config (S2DNet, bf16 patches of 16 px, ``nearest``
   references with ``keep_observations``, QKA and QBA). First
   ``localize_queries`` over a ``QueryLocalizer`` built from the decoded
   model views on ``cuda`` and then the serial path of the ``localize``
   CLI, K1's counter zeroed just before the localizer is built (reference
   extraction launches K1 too) and read just after, the stages timed:
   K1 launched, at least 7 of 8 queries localize, each within 0.5 degrees
   and 1 % of the extent of the truth after QBA, QBA costs do not rise.
   Then ``localize_batch`` on the same queries (the same successes,
   inlier counts within 2, poses within phase 14's polished limit; the
   limits of
   ``tests/test_localization.py::test_localize_batch_matches_serial``
   scaled to the scene are printed as a count), two queries on ``cuda``
   and on ``cpu`` with QBA capped at ``LOC_CPU_QBA_STEPS`` steps, held as
   phase 14 holds PnP (the same successes, inlier counts within 1, each
   device's PnP pose explains all but one of the other's inliers, PnP and
   final poses within ``PNP_POLISHED_TOL`` where both devices kept the f64
   polish, else ``PNP_UNPOLISHED_TOL``), each stage also from identical
   inputs (nearest references equal, QKA keypoints within 0.05 px, 100
   QBA steps within 1e-4), the launches and device-idle share of one QKA
   and one 10-step QBA call under the profiler, and K1 timed at this
   path's QKA shape.
19. The ``low_memory`` preset (topological_reference KA, 8 px bf16
   patches, costmap BA). (b) Phase 12's small scene (4500 observations):
   the cost patches of ``extract_costmaps`` on ``cuda`` and on ``cpu``,
   each device extracting its own references, within 1e-5 of the largest
   value; then the preset's points-only costmap BA
   (``LOWMEM_CPU_BA_ITERATIONS`` LM iterations) on each device from the
   same cost patches: without inner iterations final cost rtol 1e-4,
   points 1e-3; as shipped (inner iterations on) beside two witnesses on
   each device, the same solve with another ``obs_chunk`` and from
   starting points one float32 step away: the median point within 1e-4,
   and cost rtol 1e-3 with at most 1 % of the points beyond 1e-3 or no
   further apart than twice the farthest witness. (c) Phase 9's scene
   (56 views of 1600x1200, 40 000 points, its starting state) through
   ``run_ba`` with the ``costmaps`` strategy, 8 px patches, poses free,
   ``LOWMEM_BA_ITERATIONS`` LM iterations: the stages, grid T,
   iterations, costs, the point error to the truth (mean, median and the
   points that end over 10x the starting mean), the launches
   (counters zeroed just before, read just after: K1 and K3a/b/c must
   launch, the grid regime must be chosen, the cost must fall) and the
   peak device memory beside phase 9's ``feature_reference`` run; then
   the same under the profiler (``LOWMEM_PROFILE_ITERATIONS``), and the
   chunked costmap extraction timed at that size beside its bound.
   (a) K1 at the preset's shape: one query per observation of (c) over
   one bf16 8x8x128 patch each (the references' launch), as phase 2
   checks it. (d) The body of ``PixSfM("low_memory").triangulation`` on
   phase 11's scene, its BA capped at ``LOWMEM_TRI_BA_ITERATIONS`` LM
   iterations (100 as shipped): stage times, the keypoint error to the true
   projections and the point error to the truth, K1 launches (counters
   zeroed just before, read just after).
20. The ``photometric`` preset (dense ``image``-model maps, bf16, 3
   channels; no KA; 16-node NCC references with ``compute_offsets3D``;
   points-only ``patch_warp`` BA with constant source poses). (b) Phase
   12's scene on ``cuda`` and on ``cpu``: the dense maps equal, every
   observation's node descriptor within 1e-5 of the largest value, and
   ``patch_warp`` through ``refine_reconstruction``
   (``PHOTO_CPU_BA_ITERATIONS`` LM iterations) with joint source poses
   (``refine_extrinsics`` on: the dense step with ``src_idx``) and with
   constant ones, within phase 8's limits. (c) The body of
   ``PixSfM("photometric").triangulation`` on phase 11's scene, its BA
   capped at ``PHOTO_TRI_BA_ITERATIONS`` LM iterations (30 as shipped):
   stage times, LM iterations, costs, the point error to the truth before
   and after BA beside the default config's, K1 launches (counters zeroed
   just before, read just after); the cost must fall and the points stay
   finite; then the same under the profiler (BA capped at
   ``BA_PROFILE_ITERATIONS``). (d) ``run_ba`` with ``patch_warp`` and poses
   free (joint source poses on the flat CG layout) on (c)'s model, poses
   perturbed, LM capped at ``PHOTO_BA_ITERATIONS``: the cost must fall. (a) K1
   at the path's shape: one chunk's node queries, 16 per observation of
   8192, over one bf16 16x16x3 window per observation of (c), L2 off (the
   general variant), as phase 2 checks it.
21. The ETH3D evaluation flow (``eval/eth3d``) on one rendered
   ``make_synthetic_scene`` of ``ETH3D_VIEWS`` 1600x1200 views and
   ``ETH3D_POINTS`` points with ``ETH3D_PATCH`` px textures. (a)
   SuperPoint, R2D2 (thresholds 0: the random network's reliability stays
   under the default 0.7) and D2-Net (4096 keypoints, random weights) on
   one view at full width: ms per image (CUDA events) and keypoints; then cuda
   against cpu on a 640x480 crop: the valid keypoint sets (D2-Net's: its
   detection cells) equal outside score ties, D2-Net's sub-pixel positions
   within ``D2NET_POS_TOL``, scores within 1e-5 relative, descriptors
   within 1e-4 where the positions agree within 1e-3 px, which all but
   ``D2NET_FAR_SHARE`` of the common cells must. (b) ``run_scene`` with
   ``method="superpoint"`` with ``configs/pixsfm_eth3d.yaml`` as shipped
   (S2DNet, featuremetric KA, feature-reference BA of 10 LM iterations,
   poses fixed): accuracy and completeness at ``ETH3D_TOLERANCES``,
   points, reprojection error, stage times, launches (counters zeroed just
   before the run, read just after): K1 and K2 launched, the KA and BA
   costs fell, at least ``ETH3D_MIN_POINTS`` points, mean reprojection
   error under 3 px. (c) ``run_scene_localization`` on the same scene, 3
   held-out queries, the same preset: the AUC at ``ETH3D_LOC_THRESHOLDS``,
   the median error and the stage times; at least 2 of the 3 queries
   localize. The preset extracts each query's whole dense map, which QKA
   and QBA read as one 1200x1600x128 patch: the K1 calls on such maps are
   watched (their launches counted apart by the wrapper's own count, the
   first call's inputs kept), and K1 is held to its plain version on those
   inputs (as stored and in float32, L2 on and off) and timed there. (d) ``PixSfM.run_ka`` with ``dense_features.model.name:
   vggnet`` on phase 5's scene (three levels of 64 / 256 / 512 channels,
   bf16 16 px patches): K1 launched at each width (counters zeroed just
   before), each level's cost fell. (b) runs under the profiler (device
   activity only), (d) again under it: device-idle share
   and K1's in-situ time (in (d) per width).
22. The detector-free ETH3D path (LoFTR, ``features/models/loftr.py``) on
   phase 21's scene, random weights. (a) One pair of its views, decoded as
   ``match_loftr_dir`` decodes them (grayscale, 1024x768), at full width:
   ms per pair (CUDA events, outputs copied to the host), peak device
   memory, valid matches at the default threshold (0.2) and at 0; then
   cuda against cpu on a 256x320 crop of the pair at threshold 0: coarse
   tokens within ``LOFTR_TOKEN_RTOL`` of the largest, the valid coarse
   index pairs equal but for at most ``LOFTR_PAIR_SHARE`` of them
   (near-ties of the mutual maximum), fine positions within
   ``LOFTR_POS_TOL`` px and confidences within ``LOFTR_CONF_TOL`` of the
   largest on the common matches. (b) ``run_scene(method="loftr")`` on all
   ``ETH3D_VIEWS`` views with ``configs/pixsfm_eth3d.yaml``, through the
   harness's own entry point at its defaults: it must run to its end (the
   random network passes no pair at 0.2: 0 points). (c) The detector-free
   path at threshold 0 on ``LOFTR_VIEWS`` views, in ``run_scene``'s stage
   order: ``match_loftr_dir`` -> ``verify_all_pairs`` ->
   ``build_matching_graph`` -> ``PixSfM(pixsfm_eth3d).run_ka`` ->
   ``triangulate_reconstruction`` -> ``run_ba``, counters zeroed just
   before and read just after: K1 and K2 launched, the KA cost fell, at
   least ``LOFTR_MIN_POINTS`` points; the stage times.
23. Every interpolation config and solver option of the refinement.
   (a) The body of ``PixSfM.triangulation`` on phase 11's scene with the
   default config and 2x2 node windows at +-0.5 px (``OPT_NODES4``, L2
   on; BA capped at ``BA_ITERATIONS``): KA and feature-reference BA read
   K1's node rows at 128 channels (512 floats per keypoint and
   observation). Counters zeroed just before and read just after: K1 and
   K2 launched, the KA and BA costs fell, the points finite; the first
   node-rows launch is watched (its inputs kept) and K1 is held to its
   plain version on them (as stored and in float32, L2 on and off,
   ``check_k1``'s tolerances) and timed there. (b) The ``photometric``
   preset with ``mapping.KA.apply: true`` on phase 11's scene: KA with 16
   nodes, NCC on, L2 off on the dense RGB maps, then patch-warp BA capped
   at ``OPT_PHOTO_BA_ITERATIONS``: K1 and K2 launched, both costs fell.
   (c) Phase 18's model and queries with ``target_reference: full``
   (``compute_offsets3D``, 2x2 nodes, QKA off, patch-warp QBA of
   ``OPT_QBA_STEPS`` steps) through ``localize_queries``: all but one
   query localized; each within phase 18's bounds (0.5 deg, 1e-2 of the
   extent) where its PnP pose kept the f64 polish (QKA, which phase 18
   runs first, cannot run on "full" references, so a tied raw RANSAC
   pose, ROADMAP.md section 3, stays as far off as PnP left it: patch-warp
   QBA's basin is the node window); no QBA raised its cost or added 0.05
   deg to a query's error; one query on cuda and on cpu (QBA capped at
   ``OPT_CPU_QBA_STEPS``): the final poses within phase 14's polished
   limit, patch-warp QBA from identical inputs within 1e-4. (d) cuda
   against cpu on phase 4's scene through ``run_ka``, one run per option
   (BILINEAR, NEARESTNEIGHBOR, BICUBICCHAIN, ``cg_block_size: 2`` on the
   CG path, ``compaction_segment: 5``): keypoints within phase 4's 0.05
   px; feature-reference BA with 2x2 NCC nodes (the forward-mode Jacobian)
   on phase 12's scene with the ``image`` maps, poses free, through
   ``refine_reconstruction``: the points within phase 8's 1e-3, the cost
   within ``OPT_NCC_COST_RTOL``. Then ``run_ka`` on phase
   5's scene at full width with the default solve, with compaction and
   with block-Jacobi CG, timed in one call.
24. Sharding (``parallel/sharded.py``) over a mesh that names the card
   twice, ``Mesh((cuda:0, cuda:0))``: its two shards run in turn on the one
   card, each on its own slice (a one-card machine gives the ``parallel``
   knob no mesh, as one JAX chip does). Each step is held against the same
   call unsharded on the card, and counters are zeroed just before each
   sharded run and read just after. (a) ``solve_ka_problems`` on the
   problems of ``run_ka`` on phase 5's scene (recorded from that call),
   the problem axis over the mesh: keypoints within 5e-4 px, the cost
   within rtol 1e-4 (the JAX package's
   ``test_sharded_ka_matches_single_device``). (b) The body of
   ``PixSfM.triangulation`` on phase 11's scene (each run on its own copy
   of the reference model) with the mesh in KA, the references and
   ``feature_reference`` BA, which takes its window layout and the flat CG
   regime (BA capped at ``BA_ITERATIONS``): the same points, within 5e-3,
   the BA cost within rtol 1e-3 (``tests/test_parallel_pipeline.py``); K1
   and K2 launched, K3 not; the first window-layout launch of K1 is
   watched (its inputs kept) and K1 held to its plain version on them (as
   stored and in float32, L2 on and off) and timed there. (c) Costmap BA
   at the ``low_memory`` preset's 8 px on (b)'s model, its observations
   over the mesh in the ``costmap_window`` layout, ``SHARD_COSTMAP_
   ITERATIONS`` LM iterations without inner iterations, from one set of
   cost patches, held as phase 19(b) holds costmap BA across devices (cost
   rtol 1e-4, points 1e-3). (d) ``localize_batch`` on phase 18's 8 queries
   with the localizer's mesh (QKA problems, PnP queries and QBA queries
   over it), the references shared: the same successes, poses within
   phase 14's polished limits (``compare_localizations``).

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main paths (KA, BA, triangulation), its error against the plain version, its
time per launch (CUDA events), the plain version's time and the bound computed
from this run's inputs (``cold_ms``: K1 on query sets that change from launch
to launch, so that no tap is left in the L2 cache; ``general_ms`` and
``general_cold_ms``: the same two for K1's general variant, forced by a
misaligned copy of the rows, which is the kernel's earlier design; K2's
``variant``, ``cold_ms`` on changing systems and ``general_ms``, its earlier
design; K3b's ``variant`` and ``onepass_ms``, its earlier design;
``in_situ_ms``: the profiler's device time per launch inside the stage;
``max_abs_err`` is the error at the shape that was timed, K1's and K2's
``edge_max_abs_err`` the largest one over the edge shapes, whose tolerances are
printed with each case); K1, which every path launches at different shapes, has
one entry per path (``"path": "KA"`` / ``"BA"`` / ``"triangulation"`` /
``"reconstruction"`` / ``"localization"``, the middle two timed at their
path's BA shape, the last at its QKA shape) with that
path's launches and the figures at its shape (``"low_memory"``: the
launches of 19(c) and 19(d), split in ``launches_by_run``, and K1 timed
at 19(a); ``"photometric"``: the launches of 20(c) and 20(d), K1 timed at
20(a), its ``general_ms`` the same variant; ``"eth3d"``: the launches of
21(b) and of 21(c) on 16x16 patches, with phase 2's figures
at the KA shape; ``"eth3d_dense_query"``: 21(c)'s launches on the queries'
dense maps, with the figures on the first such launch's inputs;
``"eth3d_loftr"``: the launches of 22(c), with phase 2's figures at the
KA shape; ``"interp_options"``: the launches of 23(a), 23(b) and 23(c),
split in ``launches_by_run``, with the figures on 23(a)'s first node-rows
launch; ``"sharded"``: the launches of 24(a)-(d), split in
``launches_by_run``, with the figures on 24(b)'s first window-layout
launch; ``"vggnet"``: one entry per width, ``channels`` 64 / 256 / 512, with
21(d)'s launches at that width and phase 2's figures at it); K2's and
K3a/b/c's entries sum their launches over the paths and list them in ``launches_by_path`` (K3's ``in_situ_low_memory_ms``
from 19(c)); and last ``{"ok": true, "device": {...}}``.

The weights are each model's deterministic random init (no checkpoint
ships with the repository); the scenes are made from seeds with numpy.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# depth of the full-size BA (the default config allows 100 LM iterations;
# 8 keeps the whole run, phase 22 included, inside its time limit with a
# margin for slower hosts, whose host-bound stages take tens of percent
# longer)
BA_ITERATIONS = 8
BA_PROFILE_ITERATIONS = 2
# least share of the triangulation scene's tracks that must survive the
# acceptance rules (8000 of 8000 on an H100 with 1 px keypoint noise and the
# default 4 px limit; fixed here with a margin)
TRI_MIN_SURVIVING = 0.98
# the database keypoint adjuster against run_ka (float32 storage: ~2e-4 px)
DB_KP_ATOL = 1e-3
# phase 14: PnP queries, and the limits of cuda against cpu on the poses.
# Unpolished, a pose is the first of the minimal-sample hypotheses with the
# largest consensus; float32 rounding (P3P's near-double roots, points at the
# threshold) can change which of several tied hypotheses comes first, and
# two such poses differ by up to 4.4e-2 rad on these queries (two sample
# seeds on one device). The polish starts its Cauchy scale from the
# unpolished pose's residuals, so it narrows that spread (to 6.9e-3 rad) but
# does not close it. Both results must hold the same consensus: inlier
# counts within 1, and each pose explains all but one of the other's
# inliers.
PNP_QUERIES = 64
PNP_UNPOLISHED_TOL = 5e-2
PNP_POLISHED_TOL = 1e-2
# phase 16: the reconstruction scene
RECON_POINTS = 4000
RECON_NOISE_PX = 0.5
# phase 21: the synthetic ETH3D scene (eval/eth3d/synthetic.py) of
# tools/eth3d_synth_matrix.py (seed 5, 480x360 views, 15 px textures, its
# tolerances scaled to them) rendered at 1600x1200 with the textures scaled
# alike (15 px x 1600 / 480 -> 51 px), so that they cover the same extent
# of the scene. With random SuperPoint weights the harness triangulates
# ~2000 points from ETH3D_POINTS = 100 scene points (2007 in a CPU run of
# the refined harness); more scene points overlap their
# textures and triangulate fewer (200 -> 149 at 8 views), and 15 px textures
# at this size triangulate < 70 (the random network is not shift-equivariant
# below its stride of 8 px)
ETH3D_VIEWS = 16
ETH3D_POINTS = 100
ETH3D_PATCH = 51
ETH3D_MIN_POINTS = 500
ETH3D_TOLERANCES = (0.05, 0.15, 0.3)
ETH3D_LOC_THRESHOLDS = (0.05, 0.15, 0.5)
# D2-Net's sub-pixel Newton step solves a 2x2 system per keypoint whose
# Hessian can be near singular: it amplifies the convolutions' float32
# rounding (a 1e-6 relative change of the weights moves keypoints of a
# 640x480 crop by up to 5.6e-3 px on the CPU; its cells do not change)
D2NET_POS_TOL = 1e-2
# ... so its descriptors are compared where positions agree within 1e-3 px,
# and at most this share of the common cells may lie beyond (4 of 1170 on
# an H100): a fault that moved every position would otherwise leave no
# descriptor compared
D2NET_FAR_SHARE = 0.01
# phase 22: LoFTR on phase 21's scene. cuda against cpu on a crop: the
# coarse tokens (float32, TF32 off on both; cuDNN and the CPU sum the
# convolutions in different orders), the share of valid coarse index pairs
# that may differ (the mutual maximum is an equality on the confidence
# matrix: two near-equal entries can trade places), fine positions
LOFTR_TOKEN_RTOL = 1e-4
LOFTR_PAIR_SHARE = 0.01
LOFTR_POS_TOL = 1e-3
# ... and the confidences, relative to the largest: a product of two
# softmaxes over logits divided by the temperature 0.1, so the tokens'
# rounding (1.2e-6 of the largest on an H100) reaches the confidences
# ten-fold and more (7.8e-5 of the largest on the crop, an H100)
LOFTR_CONF_TOL = 1e-3
# (c): views of the threshold-0 path, and its least number of points: half
# of the 254 that the same stages triangulate on the CPU (the card
# machine's, 8 cores; the card: 254 too)
LOFTR_VIEWS = 8
LOFTR_MIN_POINTS = 127


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=20, warmup=3):
    """Device time per call of ``fn`` (CUDA events around ``reps`` calls).

    A sleep kernel (~0.1 s) is queued first, so the host has enqueued every
    call before the device reaches them: the wrappers' host-side launch
    cost (tens of microseconds, like the kernels themselves) would
    otherwise show up as idle time between the events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------

def _k1_queries(torch, gen, n_patches, n_queries, ps, nodes=None):
    """Random K1 queries ``(row_base, r, c)``: uniform over the patches and
    up to 1.5 px past their border; with ``nodes`` (offsets ``(dx, dy)``),
    ``n_queries / len(nodes)`` centres with their node windows, each on
    its centre's patch row (the node queries of patch-warp BA)."""
    dev = gen.device
    n = n_queries if nodes is None else n_queries // len(nodes)
    row_base = torch.randint(0, n_patches, (n,), generator=gen,
                             device=dev) * ps
    row_base[-1] = (n_patches - 1) * ps      # the last patch: top offsets
    r = torch.rand(n, generator=gen, device=dev) * (ps + 2.0) - 1.5
    c = torch.rand(n, generator=gen, device=dev) * (ps + 2.0) - 1.5
    if nodes is None:
        return row_base, r, c
    from pixsfm_tpu_torch.base.interpolation import node_queries
    return node_queries(row_base, r, c, nodes)


def _k1_bound(torch, H, W, C, row_base, r, c, l2, elem_bytes):
    """K1's bound on these queries: the distinct tap pixels they need, read
    once, plus the query inputs and the three float32 outputs, against the
    interpolation's and the L2 chain rule's operations. Returns ``(ms,
    "bytes" or "operations", bytes)``."""
    n = r.shape[0]
    taps = torch.arange(-1, 3, device=r.device)
    ri = torch.clamp(torch.floor(r).long()[:, None] + taps, 0, H - 1)
    ci = torch.clamp(torch.floor(c).long()[:, None] + taps, 0, W - 1)
    pix = ((row_base.long()[:, None, None] + ri[:, :, None]) * W
           + ci[:, None, :]).reshape(-1)
    n_pix = int(torch.unique(pix).numel())
    bytes_ = n_pix * C * elem_bytes + n * 12 + 3 * n * C * 4
    flops = n * C * (16 * 6 + (12 if l2 else 0))
    return (*_bound(bytes_, flops), bytes_)


def check_k1_recorded(torch, interpolate_cuda, rows, H, W, C, row_base, r, c,
                      l2):
    """K1 against its plain version on one launch's inputs as a path gave
    them (``rows [NR, W, C]`` in their stored type, and the same rows in
    float32), L2 on and off, at :func:`check_k1`'s tolerances; timed, and
    its bound computed, as the path launched it."""
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-3}
    worst = 0.0
    for dtype in dict.fromkeys((rows.dtype, torch.float32)):
        rows_t = rows if dtype == rows.dtype else rows.to(dtype)
        for l2_case in (False, True):
            out = interpolate_cuda.interpolate_rows(rows_t, H, W, C, row_base,
                                                    r, c, l2_case)
            ref = interpolate_cuda.interpolate_rows_plain(
                rows_t, H, W, C, row_base, r, c, l2_case)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 {str(dtype)[6:]} l2={l2_case} (N={r.shape[0]}, "
                  f"{rows.shape[0] // H} maps of {H}x{W}x{C}): max |kernel - "
                  f"plain| = {err:.3e} (atol {tols[dtype]})")
            if not all(bool(torch.isfinite(o).all()) for o in out) \
                    or err > tols[dtype]:
                raise SystemExit(f"K1 disagrees with its plain version "
                                 f"({dtype}, l2={l2_case}, {H}x{W}x{C}): "
                                 f"{err}")
            worst = max(worst, err)
        del rows_t
    ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, H, W, C, row_base, r, c, l2))
    plain_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows_plain(
        rows, H, W, C, row_base, r, c, l2), reps=5)
    bound_ms, bound_by, bytes_ = _k1_bound(
        torch, H, W, C, row_base, r, c, l2, elem_bytes=rows.element_size())
    took = interpolate_cuda.kernel_variant(rows)
    print(f"K1 timing ({str(rows.dtype)[6:]}, L2 {'on' if l2 else 'off'}, "
          f"N={r.shape[0]}, {H}x{W}x{C}, {took} variant): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bytes_ / 1e6:.2f} MB)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, variant=took,
                timed_at=f"{r.shape[0]} queries on a {H}x{W}x{C} "
                         f"{str(rows.dtype)[6:]} map")


def check_k1(torch, interpolate_cuda, n_patches, n_queries, dtypes,
             ps=16, C=128, l2=True, variant="vector", nodes=None):
    """K1 against its plain version on random patches stored in each of
    ``dtypes`` (the first one makes the random base), L2 on and off; timed
    at the path's configuration: bf16 storage, L2 ``l2``, the kernel variant
    ``variant`` (``nodes``: the queries are node windows, see
    :func:`_k1_queries`)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((n_patches * ps, ps, C), generator=gen, device=dev,
                       dtype=dtypes[0])
    row_base, r, c = _k1_queries(torch, gen, n_patches, n_queries, ps, nodes)
    r[:4] = torch.tensor([0.0, ps - 1.0, 0.25, ps - 1.25])
    c[:4] = torch.tensor([ps - 1.0, 0.0, ps - 1.5, 0.5])
    worst = 0.0
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-3}
    for dtype in dtypes:
        tol = tols[dtype]
        rows = base.to(dtype)
        for l2_case in (False, True):
            out = interpolate_cuda.interpolate_rows(rows, ps, ps, C, row_base,
                                                    r, c, l2_case)
            ref = interpolate_cuda.interpolate_rows_plain(
                rows, ps, ps, C, row_base, r, c, l2_case)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 {str(dtype)[6:]} l2={l2_case} (N={n_queries}, "
                  f"{n_patches} patches): max |kernel - plain| = {err:.3e} "
                  f"(atol {tol})")
            if not all(bool(torch.isfinite(o).all()) for o in out) \
                    or err > tol:
                raise SystemExit(f"K1 disagrees with its plain version "
                                 f"({dtype}, l2={l2_case}): {err}")
            worst = max(worst, err)
    # timing at the path's configuration: bf16 storage, L2 ``l2``
    rows = base.to(torch.bfloat16)
    del base
    row_base = row_base.to(torch.int32)   # as the callers pass it: no cast
    ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, ps, ps, C, row_base, r, c, l2))
    plain_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows_plain(
        rows, ps, ps, C, row_base, r, c, l2), reps=5)
    # the same launch on query sets that change every time: together they
    # read far more than the 50 MB L2 holds, as a caller's chunks do
    n_sets = 8
    sets = [tuple(a.to(torch.int32) if k == 0 else a for k, a in enumerate(
        _k1_queries(torch, gen, n_patches, n_queries, ps, nodes)))
        for _ in range(n_sets)]
    turn = iter(range(10 ** 9))
    cold_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        rows, ps, ps, C, *sets[next(turn) % n_sets], l2), reps=40, warmup=8)
    # the general variant on the same queries: a copy of the rows one
    # element past an aligned base, which the 16-byte loads cannot take
    # (the photometric path's 3 channels take it anyway)
    shifted = torch.empty(rows.numel() + 8, device=dev,
                          dtype=rows.dtype)[1:rows.numel() + 1].view_as(rows)
    shifted.copy_(rows)
    if interpolate_cuda.kernel_variant(shifted) != "general":
        raise SystemExit("K1 took 16-byte loads on a misaligned base")
    general_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        shifted, ps, ps, C, row_base, r, c, l2))
    general_cold_ms = _time_ms(lambda: interpolate_cuda.interpolate_rows(
        shifted, ps, ps, C, *sets[next(turn) % n_sets], l2), reps=40,
        warmup=8)
    del shifted
    bound_ms, bound_by, bytes_ = _k1_bound(torch, ps, ps, C, row_base, r, c,
                                           l2, elem_bytes=2)
    took = interpolate_cuda.kernel_variant(rows)
    print(f"K1 timing (bf16, L2 {'on' if l2 else 'off'}, N={n_queries}, "
          f"{n_patches} patches of {ps}x{ps}x{C}, {took} variant): kernel "
          f"{ms:.4f} ms ({cold_ms:.4f} ms on changing query sets), general "
          f"variant {general_ms:.4f} ms ({general_cold_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bytes_ / 1e6:.1f} MB)")
    if took != variant:
        raise SystemExit(f"K1 did not take its {variant} variant at a "
                         f"path's shape")
    return dict(max_abs_err=worst, ms=ms, cold_ms=cold_ms,
                general_ms=general_ms, general_cold_ms=general_cold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k1_edges(torch, interpolate_cuda):
    """K1 against its plain version at small shapes that reach the general
    variant and the edges of the vector one, at the tolerances of
    :func:`check_k1`. Returns the largest error."""
    dev = torch.device("cuda")
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-3}
    # (dtype, C, H, W, misaligned base, expected variant)
    cases = [(torch.bfloat16, 20, 16, 16, False, "general"),
             (torch.bfloat16, 136, 16, 16, False, "general"),
             (torch.float32, 20, 16, 16, False, "general"),
             (torch.float32, 128, 16, 16, False, "vector"),
             (torch.bfloat16, 128, 3, 3, False, "vector"),
             (torch.float32, 128, 3, 3, False, "vector"),
             (torch.bfloat16, 20, 3, 3, False, "general"),
             (torch.bfloat16, 128, 16, 16, True, "general"),
             (torch.float32, 128, 16, 16, True, "general")]
    worst = 0.0
    for dtype, C, H, W, misaligned, want in cases:
        gen = torch.Generator(device=dev).manual_seed(C + H)
        n_patches, n = 40, 1501
        numel = n_patches * H * W * C
        buf = torch.randn(numel + 8, generator=gen, device=dev).to(dtype)
        # one element past an aligned base: 2 or 4 bytes off
        rows = buf[1:numel + 1] if misaligned else buf[:numel]
        rows = rows.view(n_patches * H, W, C)
        row_base = torch.randint(0, n_patches, (n,), generator=gen,
                                 device=dev) * H
        r = torch.rand(n, generator=gen, device=dev) * (H + 2.0) - 1.5
        c = torch.rand(n, generator=gen, device=dev) * (W + 2.0) - 1.5
        r[:4] = torch.tensor([0.0, H - 1.0, 0.25, H - 1.25])
        c[:4] = torch.tensor([W - 1.0, 0.0, W - 1.5, 0.5])
        got = interpolate_cuda.kernel_variant(rows)
        for l2 in (False, True):
            out = interpolate_cuda.interpolate_rows(rows, H, W, C, row_base,
                                                    r, c, l2)
            ref = interpolate_cuda.interpolate_rows_plain(rows, H, W, C,
                                                          row_base, r, c, l2)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            print(f"K1 edge {str(dtype)[6:]} C={C} {H}x{W} "
                  f"{'misaligned ' if misaligned else ''}l2={l2} ({got} "
                  f"variant): max |kernel - plain| = {err:.3e} (atol "
                  f"{tols[dtype]})")
            if got != want or err > tols[dtype] or not all(
                    bool(torch.isfinite(o).all()) for o in out):
                raise SystemExit(f"K1 edge case failed: {dtype} C={C} "
                                 f"{H}x{W} misaligned={misaligned} l2={l2}: "
                                 f"variant {got} (expected {want}), error "
                                 f"{err}")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def _spd(torch, P, N, seed):
    """A batch of SPD systems on the card: (H, g, damp)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((P, N, N), generator=gen, device=dev)
    H = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    g = torch.randn((P, N), generator=gen, device=dev)
    damp = torch.rand((P, N), generator=gen, device=dev) * 0.1
    return H, g, damp


def _k2_err(torch, cg_cuda, H, g, damp, iters, variant, what):
    """Largest |kernel - plain| over the folded and explicit forms; fails
    past rtol/atol 1e-4."""
    worst = 0.0
    for name, Hx, dx in (("folded damping", H, damp),
                         ("explicit Hd", H + torch.diag_embed(damp), None)):
        out = cg_cuda.pcg_solve(Hx, g, iters, damp=dx, variant=variant)
        ref = cg_cuda.pcg_solve_plain(Hx, g, iters, damp=dx)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and bool(
            ((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        print(f"K2 {what}, {variant} variant, {name}: max |kernel - plain| "
              f"= {err:.3e} (rtol/atol 1e-4)")
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version ({what}, "
                             f"{variant}, {name})")
        worst = max(worst, err)
    return worst


# (P, N, iters) besides the main path's: more systems than SMs, one system,
# zero and one step, the register variant's largest N, N that take the
# general variant (odd, the first multiple of 4 past 128, 200)
K2_EDGES = [(300, 112, 15), (1, 112, 15), (128, 112, 0), (128, 112, 1),
            (64, 128, 15), (64, 51, 15), (64, 132, 15), (9, 200, 15)]


def check_k2(torch, cg_cuda, P, N, iters):
    """K2 against its plain version, each variant that a shape allows, at
    the main path's shape and at :data:`K2_EDGES`; timed at the main path's
    shape on a repeated H, on H sets that change from launch to launch
    (``cold_ms``) and through the general variant (``general_ms``)."""
    variant = cg_cuda.kernel_variant(N)
    if variant != "register":
        raise SystemExit(f"K2 takes its {variant} variant at the main "
                         f"path's N={N}")
    H, g, damp = _spd(torch, P, N, seed=2)
    err = _k2_err(torch, cg_cuda, H, g, damp, iters, variant,
                  f"P={P} N={N} iters={iters}")
    edge = _k2_err(torch, cg_cuda, H, g, damp, iters, "general",
                   f"P={P} N={N} iters={iters}")
    seen = {variant, "general"}
    for Pe, Ne, it in K2_EDGES:
        He, ge, de = _spd(torch, Pe, Ne, seed=Pe + Ne + it)
        for v in sorted({cg_cuda.kernel_variant(Ne), "general"}):
            edge = max(edge, _k2_err(torch, cg_cuda, He, ge, de, it, v,
                                     f"P={Pe} N={Ne} iters={it}"))
            seen.add(v)
    if seen != set(cg_cuda.VARIANTS):
        raise SystemExit(f"K2 variants not reached: {seen}")
    ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, iters, damp=damp))
    general_ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, iters, damp=damp,
                                                    variant="general"))
    plain_ms = _time_ms(lambda: cg_cuda.pcg_solve_plain(H, g, iters,
                                                        damp=damp))
    # the load and set-up alone: the same launch with no CG step
    zero_ms = _time_ms(lambda: cg_cuda.pcg_solve(H, g, 0, damp=damp))
    general_zero_ms = _time_ms(lambda: cg_cuda.pcg_solve(
        H, g, 0, damp=damp, variant="general"))
    # 20 sets of 6.4 MB, more than the 50 MB L2 holds, as the LM's
    # systems change from launch to launch
    n_sets = 20
    sets = [_spd(torch, P, N, seed=1000 + k) for k in range(n_sets)]
    turn = iter(range(10 ** 9))

    def cold():
        Hs, gs, ds = sets[next(turn) % n_sets]
        cg_cuda.pcg_solve(Hs, gs, iters, damp=ds)
    cold_ms = _time_ms(cold, reps=40, warmup=8)
    del sets
    bytes_ = P * N * N * 4 + 3 * P * N * 4
    flops = P * (iters * (2 * N * N + 13 * N) + 5 * N)
    bound_ms, bound_by = _bound(bytes_, flops)
    print(f"K2 timing (P={P}, N={N}, {iters} iters, {variant} variant): "
          f"kernel {ms:.4f} ms ({cold_ms:.4f} ms on changing systems; "
          f"{zero_ms:.4f} ms with no step, so "
          f"{(ms - zero_ms) / iters * 1e3:.3f} us per step), general "
          f"variant {general_ms:.4f} ms ({general_zero_ms:.4f} ms with no "
          f"step, {(general_ms - general_zero_ms) / iters * 1e3:.3f} us per "
          f"step), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return dict(variant=variant, max_abs_err=err, edge_max_abs_err=edge,
                ms=ms, cold_ms=cold_ms, general_ms=general_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# synthetic scene: views of one textured plane under mild homographies
# ---------------------------------------------------------------------------

def _bound(bytes_, flops):
    """(bound ms, what sets it) at the H100's peak rates."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# phase 7: K3a/b/c
# ---------------------------------------------------------------------------

def k3_inputs(torch, schur_cuda, T, I, Nc, k, P, n_obs, seed=7,
              device="cuda"):
    """Grid-packed Schur inputs at the BA main path's shape: ``n_obs`` real
    observations spread over P points x T ranks, the other slots holes
    (zero W blocks, indices at slot 0)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    NR = 6 + k
    O = P * T
    Bt = torch.randn((NR * 3, O), generator=gen, device=dev)
    img = torch.randint(0, I, (O,), generator=gen, device=dev)
    cam = torch.randint(0, Nc, (O,), generator=gen, device=dev)
    hole = torch.rand(O, generator=gen, device=dev) >= n_obs / O
    Bt[:, hole] = 0.0
    img[hole] = 0
    cam[hole] = 0
    A = torch.randn((P, 3, 3), generator=gen, device=dev)
    Vinv = torch.einsum("pab,pcb->acp", A, A) \
        + 3 * torch.eye(3, device=dev)[:, :, None]
    Btr, img_r, cam_r, Vi, Ppad = schur_cuda.pack_grid_blocks(
        Bt, img, cam, Vinv, T)
    return dict(vpT=torch.randn((6, I), generator=gen, device=dev),
                vcT=torch.randn((k, Nc), generator=gen, device=dev),
                Btr=Btr, img_r=img_r, cam_r=cam_r, Vinv=Vi,
                gx=torch.randn((3, Ppad), generator=gen, device=dev))


def check_k3(torch, schur_cuda, T, I, Nc, k, P, n_obs, device="cuda",
             timed=True, seed=7):
    """Each K3 kernel against its plain version (K3b also forced to its
    one-pass variant, ``"K3b onepass"``). Tolerance: |kernel - ref|
    <= 2e-5 |ref| + 1e-6 S per entry, ref the plain version in float64 and
    S the same sums over absolute values (the kernels add in another,
    atomic, order, so their float32 error grows with S, not |ref|). With
    ``timed`` each kernel and its plain version are also timed and the bound
    is computed."""
    x = k3_inputs(torch, schur_cuda, T, I, Nc, k, P, n_obs, seed=seed,
                  device=device)
    dims = dict(T=T, I=I, Nc=Nc, k=k)
    cases = {
        "K3a": (lambda a: schur_cuda.schur_term_matvec(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    a["Vinv"], **dims),
                lambda a: schur_cuda.schur_term_matvec_plain(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    a["Vinv"])),
        "K3b": (lambda a: schur_cuda.schur_rhs(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"],
                    **dims),
                lambda a: schur_cuda.schur_rhs_plain(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"], I,
                    Nc)),
        "K3b onepass": (lambda a: schur_cuda.schur_rhs(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"],
                    variant="onepass", **dims),
                lambda a: schur_cuda.schur_rhs_plain(
                    a["Btr"], a["img_r"], a["cam_r"], a["Vinv"], a["gx"], I,
                    Nc)),
        "K3c": (lambda a: (schur_cuda.schur_backsub(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"],
                    **dims),),
                lambda a: (schur_cuda.schur_backsub_plain(
                    a["vpT"], a["vcT"], a["Btr"], a["img_r"], a["cam_r"]),)),
    }
    x64 = {n: v.double() if v.is_floating_point() else v for n, v in x.items()}
    xabs = {n: v.abs() if v.is_floating_point() else v
            for n, v in x64.items()}
    NR = 6 + k
    n_in = x["Btr"].numel() * 4 + 2 * x["img_r"].numel() * 4
    tables = (6 * I + k * Nc) * 4
    bytes_ = {"K3a": n_in + x["Vinv"].numel() * 4 + 2 * tables,
              "K3b": n_in + x["Vinv"].numel() * 4 + x["gx"].numel() * 4
              + tables,
              "K3b onepass": n_in + x["Vinv"].numel() * 4
              + x["gx"].numel() * 4 + tables,
              "K3c": n_in + tables + x["gx"].numel() * 4}
    per_obs = P * T * NR * 3 * 2
    flops = {"K3a": 2 * per_obs + 18 * P, "K3b": per_obs + 18 * P,
             "K3b onepass": per_obs + 18 * P, "K3c": per_obs}
    out = {}
    for name, (kern, plain) in cases.items():
        got = kern(x)
        ref32 = plain(x)
        torch.cuda.synchronize()
        err = _max_err(got, ref32)
        ratio = max(float(((g.double() - r).abs()
                           / (2e-5 * r.abs() + 1e-6 * s + 1e-30)).max())
                    for g, r, s in zip(got, plain(x64), plain(xabs)))
        scale = max(float(r.abs().max()) for r in ref32)
        print(f"{name}: max |kernel - plain| = {err:.3e} (max |plain| "
              f"{scale:.3e}); error / tolerance (2e-5 |ref| + 1e-6 S vs "
              f"float64) = {ratio:.3f}")
        if not all(bool(torch.isfinite(g).all()) for g in got) \
                or not ratio <= 1.0:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"(T={T}, k={k}, I={I}, Nc={Nc}, P={P})")
        if not timed:
            out[name] = dict(max_abs_err=err)
            continue
        ms = _time_ms(lambda: kern(x))
        plain_ms = _time_ms(lambda: plain(x), reps=5)
        bound_ms, bound_by = _bound(bytes_[name], flops[name])
        print(f"{name} timing (T={T}, k={k}, I={I}, Nc={Nc}, P={P}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bytes_[name] / 1e6:.1f} MB)")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return out


def check_k3_edges(torch, schur_cuda):
    """K3a/b/c against their plain versions at small shapes that together
    reach every variant of K3a and of K3b, at :func:`check_k3`'s
    tolerance."""
    # (T, I, Nc, k, points, observations)
    cases = [(1, 13, 3, 4, 1024, 700),        # one rank, mixed camera slots
             (5, 13, 3, 1, 4096, 15000),      # T not a power of two, k = 1
             (8, 2, 1, 8, 4096, 30000),       # k = 8, few slots: large groups
             (12, 7, 2, 3, 2048, 20000),      # two ranks per warp, odd T / 2
             (16, 13, 3, 8, 4096, 50000),     # T = 16, k = 8
             (20, 13, 3, 4, 2048, 30000),     # T > 16: two passes
             (4, 3000, 2, 4, 4096, 12000),    # tables above shared memory
             (16, 3000, 2, 8, 4096, 50000),
             (20, 3000, 2, 4, 2048, 30000)]
    seen, seen_rhs = set(), set()
    for n, (T, I, Nc, k, P, n_obs) in enumerate(cases):
        variant = schur_cuda.matvec_variant(T, k, I, Nc, P)
        rhs = schur_cuda.rhs_variant(T, k, I, Nc, P)
        seen.add(variant)
        seen_rhs.add(rhs)
        print(f"K3 edge T={T} k={k} I={I} Nc={Nc} P={P} (K3a variant "
              f"{variant}, K3b variant {rhs}):")
        check_k3(torch, schur_cuda, T=T, I=I, Nc=Nc, k=k, P=P, n_obs=n_obs,
                 timed=False, seed=100 + n)
    for name, got, kinds in (("K3a", seen, ("fused1", "fused2", "twopass")),
                             ("K3b", seen_rhs,
                              ("fused1", "fused2", "onepass"))):
        want = {f"{v}/{m}" for v in kinds for m in ("shared", "global")}
        if got != want:
            raise SystemExit(f"{name} variants not reached: "
                             f"{sorted(want - got)}")


# ---------------------------------------------------------------------------
# phase 8: small BA, cuda against cpu
# ---------------------------------------------------------------------------

def small_ba(torch, np, device):
    """Geometric BA on a 5-view synthetic scene through ``ba_solve`` on the
    grid layout (T = 8, chunks of 64): (final cost, points, summary)."""
    from pixsfm_tpu_torch.base.geometry import (exp_quat_np, quat_mul,
                                                quat_normalize)
    from pixsfm_tpu_torch.bundle_adjustment.main import _RESIDUAL_BUILDERS
    from pixsfm_tpu_torch.bundle_adjustment.problem import pack_ba_problem
    from pixsfm_tpu_torch.base.losses import RobustLoss
    from pixsfm_tpu_torch.ops import schur
    from pixsfm_tpu_torch.sfm.synthetic import synthetic_reconstruction
    rec = synthetic_reconstruction(n_images=5, n_points=80, noise_px=0.4,
                                   seed=72)
    rng = np.random.default_rng(0)
    for iid in sorted(rec.images)[1:]:
        im = rec.images[iid]
        dq = torch.as_tensor(exp_quat_np(rng.normal(0, 0.003, 3)))
        im.qvec = quat_normalize(quat_mul(dq, torch.as_tensor(
            im.qvec))).numpy()
        im.tvec = im.tvec + rng.normal(0, 0.02, 3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 0.02, 3)
    packed = pack_ba_problem(rec)
    Np, T = len(packed.point_ids), 8
    order = np.argsort(packed.obs_pt, kind="stable")
    sp = packed.obs_pt[order]
    starts = np.searchsorted(sp, np.arange(Np), side="left")
    slot = sp * T + (np.arange(len(sp)) - starts[sp])
    src = np.zeros(Np * T, np.int64)
    valid = np.zeros(Np * T, bool)
    src[slot], valid[slot] = order, True

    def put(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    obs = schur.BAObservations(
        put(packed.obs_img[src], torch.long),
        put(packed.obs_cam[src], torch.long),
        put(np.arange(Np * T) // T, torch.long),
        (put(packed.obs_xy[src], torch.float32),), put(valid))
    state0 = schur.BAState(*(put(a, torch.float32) for a in (
        packed.qvec, packed.tvec, packed.cams, packed.xyz)))
    build, build_jac = _RESIDUAL_BUILDERS["geometric"]
    st, summ = schur.ba_solve(
        build(packed.cam_model), state0, obs, RobustLoss("trivial"),
        *(put(a) for a in (packed.pose_free, packed.tvec_free,
                           packed.cam_free, packed.point_free)),
        opts=schur.BAOptions(max_iterations=12, obs_chunk=64,
                             linear_solver="cg", obs_grid_T=T),
        residual_jac_fn=build_jac(packed.cam_model))
    return summ["final_cost"], st.xyz.cpu().numpy(), summ


# ---------------------------------------------------------------------------
# phase 9: rendered views of a textured plane for BA
# ---------------------------------------------------------------------------

def _look_at(np, eye, target):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])   # rows: camera axes (world)


def make_ba_scene(torch, np, seed, n_views, n_points, W, H, device,
                  min_track=4, max_track=8, margin=24, noise_px=0.3):
    """A reconstruction of ``n_points`` points on the textured plane z = 0,
    seen by ``n_views`` SIMPLE_RADIAL cameras (1.8-2.4 units away, tilted
    10-35 degrees); each point's track is a random subset of
    ``min_track``-``max_track`` of the views that see it (``margin`` px
    inside the image), its keypoints the true projections plus
    N(0, ``noise_px``). The views are rendered on ``device`` (plane ->
    image homographies of the true poses). Returns (reconstruction with
    perturbed poses and points, {name: [H, W, 3] uint8}, the true
    reconstruction, whose images hold the keypoints)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.base.geometry import (exp_quat_np, quat_mul,
                                                quat_normalize,
                                                rotmat_to_quat_np)
    from pixsfm_tpu_torch.base.projection import project_np
    from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, 0.0])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    poses = []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        tilt = rng.uniform(0.17, 0.61)
        target = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           0.0])
        eye = target + rng.uniform(1.8, 2.4) * np.array(
            [np.sin(tilt) * np.cos(ang), np.sin(tilt) * np.sin(ang),
             np.cos(tilt)])
        R = _look_at(np, eye, target)
        poses.append((R, -R @ eye))

    # texture: 8 plane waves of 20-100 cycles per unit, mixed into RGB
    n_waves = 8
    freq = rng.uniform(20, 100, n_waves) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, n_waves))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    mix = rng.normal(0, 1, (n_waves, 3))
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))
    dev = torch.device(device)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1)
    fw = torch.as_tensor(np.stack([freq.real, freq.imag], 1), device=dev)
    images = {}
    for v, (R, t) in enumerate(poses):
        Hm = K @ np.stack([R[:, 0], R[:, 1], t], 1)     # plane -> image
        q = pix @ torch.as_tensor(np.linalg.inv(Hm).T, device=dev)
        X = q[..., :2] / q[..., 2:]
        img = torch.full((H, W, 3), 127.5, dtype=torch.float64, device=dev)
        for k in range(n_waves):
            wave = torch.sin(2 * np.pi * (X @ fw[k]) + phase[k])
            img += wave[..., None] * torch.as_tensor(mix[k], device=dev)
        images[f"view{v:03d}.png"] = img.clamp(0, 255).to(torch.uint8) \
            .cpu().numpy()

    # points and tracks
    n_cand = 2 * n_points
    P3 = np.concatenate([rng.uniform(-0.8, 0.8, (n_cand, 2)),
                         np.zeros((n_cand, 1))], 1)
    vis = np.zeros((n_cand, n_views), bool)
    proj = np.zeros((n_cand, n_views, 2))
    for v, (R, t) in enumerate(poses):
        xy, z = project_np(cam, rotmat_to_quat_np(R), t, P3)
        proj[:, v] = xy
        vis[:, v] = (z > 0) & (xy[:, 0] >= margin) & (xy[:, 0] < W - margin) \
            & (xy[:, 1] >= margin) & (xy[:, 1] < H - margin)
    keep = np.nonzero(vis.sum(1) >= min_track)[0][:n_points]
    if len(keep) < n_points:
        raise SystemExit(f"scene: only {len(keep)} points seen by "
                         f"{min_track} views")
    P3, vis, proj = P3[keep], vis[keep], proj[keep]
    L = np.minimum(rng.integers(min_track, max_track + 1, n_points),
                   vis.sum(1))
    keys = np.where(vis, rng.random(vis.shape), np.inf)
    chosen = np.argsort(keys, axis=1)
    in_track = np.zeros_like(vis)
    rows = np.repeat(np.arange(n_points), L)
    cols = chosen[rows, np.concatenate([np.arange(n) for n in L])]
    in_track[rows, cols] = True

    truth = Reconstruction()
    truth.add_camera(cam)
    tracks = [[] for _ in range(n_points)]
    for v, (R, t) in enumerate(poses):
        pts = np.nonzero(in_track[:, v])[0]
        xy = proj[pts, v] + rng.normal(0, noise_px, (len(pts), 2))
        for j, p in enumerate(pts):
            tracks[p].append((v + 1, j))
        truth.add_image(Image(v + 1, f"view{v:03d}.png", 1,
                              rotmat_to_quat_np(R), t, xy, pts))
    for p in range(n_points):
        truth.add_point3D(Point3D(p, P3[p], track=tracks[p]))
    rec = truth.copy()
    for iid in sorted(rec.images)[1:]:
        im = rec.images[iid]
        dq = torch.as_tensor(exp_quat_np(rng.normal(0, 3e-4, 3)))
        im.qvec = quat_normalize(quat_mul(dq, torch.as_tensor(
            im.qvec))).numpy()
        im.tvec = im.tvec + rng.normal(0, 1e-3, 3)
    for p in rec.points3D.values():
        p.xyz = p.xyz + rng.normal(0, 1e-3, 3)
    return rec, images, truth


def point_error(np, rec, truth):
    return float(np.mean([np.linalg.norm(rec.points3D[p].xyz - q.xyz)
                          for p, q in truth.points3D.items()]))


def make_scene(np, seed, n_views, n_points, W, H, margin):
    rng = np.random.default_rng(seed)
    n_waves = 8
    freq = rng.uniform(1 / 48, 1 / 10, n_waves) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, n_waves))
    fx, fy = freq.real.astype(np.float32), freq.imag.astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    mix = rng.normal(0, 1, (n_waves, 3)).astype(np.float32)
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))

    homs = []
    for v in range(n_views):
        if v == 0:
            homs.append(np.eye(3))
            continue
        a = rng.uniform(-0.05, 0.05)
        s = rng.uniform(0.97, 1.03)
        Hm = np.array([[s * np.cos(a), -s * np.sin(a), rng.uniform(-20, 20)],
                       [s * np.sin(a), s * np.cos(a), rng.uniform(-20, 20)],
                       [rng.uniform(-1e-5, 1e-5), rng.uniform(-1e-5, 1e-5),
                        1.0]])
        # keep the image centre fixed so every point stays in view
        ctr = np.array([W / 2, H / 2, 1.0])
        moved = Hm @ ctr
        T = np.eye(3)
        T[:2, 2] = ctr[:2] - moved[:2] / moved[2] + Hm[:2, 2]
        homs.append(T @ Hm)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)   # centres
    images = {}
    for v, Hm in enumerate(homs):
        q = pix @ np.linalg.inv(Hm).T.astype(np.float32)
        u, w = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
        img = np.full((H, W, 3), 127.5, np.float32)
        for k in range(n_waves):
            wave = np.sin(2 * np.pi * (fx[k] * u + fy[k] * w) + phase[k])
            img += wave[..., None] * mix[k]
        images[f"view{v:02d}.png"] = np.clip(img, 0, 255).astype(np.uint8)

    X = np.stack([rng.uniform(margin, W - margin, n_points),
                  rng.uniform(margin, H - margin, n_points),
                  np.ones(n_points)], -1)
    truth, keypoints = {}, {}
    for v, (name, Hm) in enumerate(zip(images, homs)):
        p = X @ Hm.T
        truth[name] = p[:, :2] / p[:, 2:]
        noise = rng.normal(0, 1.0, truth[name].shape) if v else 0.0
        keypoints[name] = truth[name] + noise
    names = list(images)
    ident = np.stack([np.arange(n_points)] * 2, axis=1)
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            matches[(a, b)] = ident
            # the unperturbed reference view matches best, so its
            # keypoints become the (frozen) track roots
            scores[(a, b)] = np.full(n_points, 1.0 if i == 0 else 0.5)
    return images, keypoints, truth, matches, scores


def gt_error(np, keypoints, truth, names):
    return float(np.mean([np.linalg.norm(keypoints[n] - truth[n], axis=1)
                          for n in names]))


def profile_stage(torch, fn, cpu=True):
    """Run ``fn`` under torch.profiler: (result, wall s, device-busy s,
    [(kernel, calls, device ms)] by device time, full table). ``cpu``:
    record the host-side operators too (their summary takes tens of
    seconds on a long stage of many small operators)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in avg if e.device_type == DeviceType.CUDA),
                  key=lambda k: -k[2])
    busy = sum(k[2] for k in kern) / 1e3
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    return res, wall, busy, kern, table


def _in_situ(kern, tags, launched):
    """Device ms per launch inside a profiled stage, per kernel id: every
    profiled kernel whose name contains the id's tag (the variants of one
    kernel share it). A kernel that ``launched`` on the main path and shows
    no launch in the profile fails the run."""
    out = {}
    for key, tag in tags.items():
        hits = [(c, ms) for n, c, ms in kern if tag in n]
        calls = sum(c for c, _ in hits)
        if calls:
            out[key] = sum(ms for _, ms in hits) / calls
        elif launched.get(key, 0) > 0:
            raise SystemExit(f"{key} launched on the main path but the "
                             f"profile shows no kernel named *{tag}*")
    return out


def _took_variant(kern, key, want, other):
    """Fail unless a profiled stage launched kernel ``want`` and never
    ``other`` (two variants of kernel ``key``)."""
    names = {n for n, _, _ in kern}
    if not any(want in n for n in names) or any(other in n for n in names):
        raise SystemExit(f"{key}: the main path did not take {want} alone")
    print(f"{key}: the main path launched {want} only")


# ---------------------------------------------------------------------------
# phases 11-13: the triangulation main path, the dense step, the database KA
# ---------------------------------------------------------------------------

def triangulation_inputs(np, truth):
    """What an hloc user hands ``PixSfM.triangulation``, from a scene of
    :func:`make_ba_scene`: keypoints per view (its images' ``xys``),
    matches over every view pair within each track (score 1) and the
    reference model (the true poses and intrinsics, no points)."""
    from pixsfm_tpu_torch.sfm.model import Image, Reconstruction
    keypoints = {im.name: im.xys.copy() for im in truth.images.values()}
    n_pts = len(truth.points3D)
    kp_of = {}                        # view name -> keypoint index per point
    for im in truth.images.values():
        idx = np.full(n_pts, -1)
        idx[im.point3D_ids] = np.arange(len(im.point3D_ids))
        kp_of[im.name] = idx
    names = sorted(kp_of)
    matches, scores = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            both = (kp_of[a] >= 0) & (kp_of[b] >= 0)
            if both.any():
                matches[(a, b)] = np.stack([kp_of[a][both], kp_of[b][both]],
                                           1)
                scores[(a, b)] = np.ones(int(both.sum()))
    reference = Reconstruction()
    for cam in truth.cameras.values():
        reference.add_camera(cam)
    for im in truth.images.values():
        reference.add_image(Image(im.image_id, im.name, im.camera_id,
                                  im.qvec.copy(), im.tvec.copy()))
    return keypoints, matches, scores, reference


def triangulated_error(np, rec, truth):
    """Mean distance of triangulated points to the true points they track
    (a track's first observation names its true point)."""
    errs = []
    for p in rec.points3D.values():
        iid, k = p.track[0]
        true_id = int(truth.images[iid].point3D_ids[k])
        errs.append(np.linalg.norm(p.xyz - truth.points3D[true_id].xyz))
    return float(np.mean(errs))


def dlt_stack(torch, np, truth):
    """The DLT constraint stack ``[tracks, 2 T, 4]`` (``T`` the longest
    track, zero rows past a track's end) of the keypoints of a scene of
    :func:`make_ba_scene` (SIMPLE_RADIAL with k = 0: undistortion is the
    identity), on the card: what ``triangulate_batch`` gets on the
    triangulation path."""
    f, cx, cy, _ = truth.cameras[1].params
    P = {iid: np.hstack([im.rotation_matrix(), im.tvec[:, None]])
         for iid, im in truth.images.items()}
    tracks = [p.track for p in truth.points3D.values()]
    T = max(len(t) for t in tracks)
    A = np.zeros((len(tracks), T, 2, 4))
    for i, track in enumerate(tracks):
        for k, (iid, j) in enumerate(track):
            u, v = (truth.images[iid].xys[j] - [cx, cy]) / f
            A[i, k] = [u * P[iid][2] - P[iid][0], v * P[iid][2] - P[iid][1]]
    return torch.as_tensor(A.reshape(len(tracks), 2 * T, 4),
                           dtype=torch.float32, device="cuda")


def dense_ba(torch, np, rec, views, device, tmp):
    """``refine_reconstruction`` (the ``bundle_adjuster`` command's function)
    of ``rec`` written to ``tmp`` on ``device`` with the geometric strategy:
    (summary of the one level, points, wall s). Geometric, because the
    featuremetric cost on S2DNet's random features has near-equal minima:
    two runs whose starts differ by 1e-6 end further apart than phase 8's
    limits, so a CUDA/CPU comparison there would test the landscape, not
    the step."""
    from pixsfm_tpu_torch.refine_hloc import PixSfM
    src = Path(tmp) / "dense_in"
    rec.write(src)
    sfm = PixSfM({"mapping": {"BA": {
        "strategy": "geometric",
        "optimizer": {"solver": {"max_num_iterations": BA_ITERATIONS}}}}},
        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_rec, out = sfm.refine_reconstruction(Path(tmp) / f"dense_{device}",
                                             src, views)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xyz = np.stack([out_rec.points3D[p].xyz for p in sorted(out_rec.points3D)])
    return {k: v[0] for k, v in out.items()}, xyz, wall


def mixed_models(rec):
    """``rec`` with its odd images moved to a PINHOLE camera of the same
    intrinsics (the scene's SIMPLE_RADIAL camera has k = 0, so the views
    and keypoints stay exact): two camera models in one BA."""
    from pixsfm_tpu_torch.base.cameras import Camera
    out = rec.copy()
    cam = out.cameras[1]
    f, cx, cy, _ = cam.params
    out.add_camera(Camera(2, "PINHOLE", cam.width, cam.height,
                          [f, f, cx, cy]))
    for iid, im in out.images.items():
        if iid % 2:
            im.camera_id = 2
    return out


def write_database(np, path, keypoints, matches, W, H):
    """A COLMAP database of ``keypoints`` (float32, as COLMAP stores them)
    and ``matches``, written with the port's ``COLMAPDatabase``."""
    from contextlib import closing
    from pixsfm_tpu_torch.util.database import COLMAPDatabase
    with closing(COLMAPDatabase.connect(path)) as db:
        db.create_tables()
        cam = db.add_camera(2, W, H, [1.2 * W, W / 2, H / 2, 0.0])
        ids = {name: db.add_image(name, cam) for name in keypoints}
        for name, kps in keypoints.items():
            db.add_keypoints(ids[name], kps)
        for (a, b), m in matches.items():
            db.add_matches(ids[a], ids[b], m)
        db.commit()


# ---------------------------------------------------------------------------
# phases 14-17: PnP, the incremental mapper, the reconstruction path, dsift
# ---------------------------------------------------------------------------

def _rot(np, phi):
    th = max(float(np.linalg.norm(phi)), 1e-300)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pnp_queries(np, seed, n_queries, n=None):
    """PnP queries of 30-2000 correspondences (log-uniform; ``n`` each when
    given): half of them on a plane, 0-60 % outliers, SIMPLE_RADIAL and
    PINHOLE cameras in turn, keypoints the true projections plus
    N(0, 0.5 px)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.localization.pnp import (_rotmat_to_quat_np,
                                                   project_np)
    rng = np.random.default_rng(seed)
    queries = []
    for i in range(n_queries):
        n_i = int(np.exp(rng.uniform(np.log(30), np.log(2000))))
        n_i = n_i if n is None else n
        W, H = 1600, 1200
        cam = (Camera(1, "SIMPLE_RADIAL", W, H, [1700.0, W / 2, H / 2, 0.02])
               if i % 2 else Camera(1, "PINHOLE", W, H,
                                    [1650.0, 1700.0, W / 2, H / 2]))
        X = np.stack([rng.uniform(-2.5, 2.5, n_i), rng.uniform(-2, 2, n_i),
                      rng.uniform(-1.5, 1.5, n_i)], 1)
        if i % 4 < 2:
            X[:, 2] = 0.3 * X[:, 0] - 0.1 * X[:, 1]
        R = _rot(np, rng.normal(0, 0.3, 3))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), 8.0])
        xy, _ = project_np(cam, _rotmat_to_quat_np(R), t, X)
        xy = xy + rng.normal(0, 0.5, xy.shape)
        k = int(rng.uniform(0, 0.6) * n_i)
        xy[:k] = rng.uniform(0, [W, H], (k, 2))
        queries.append(dict(points2D=xy, points3D=X, camera=cam))
    return queries


def pose_agreement(np, a, b, X):
    """(rotation angle between two PnP results, translation difference
    relative to max(|t|, median distance of the points to the camera)).
    The angle is 2 atan2(|v|, |w|) of the relative quaternion (w, v), in
    float64 after renormalizing both: arccos of the quaternions' dot
    product cannot resolve angles below ~1e-3 rad from float32 inputs."""
    from pixsfm_tpu_torch.localization.pnp import (_quat_mul_np,
                                                   _quat_to_rotmat_np)
    qa, qb = (np.asarray(r["qvec"], np.float64) for r in (a, b))
    rel = _quat_mul_np(qa / np.linalg.norm(qa),
                       (qb / np.linalg.norm(qb)) * [1, -1, -1, -1])
    ang = 2 * np.arctan2(np.linalg.norm(rel[1:]), abs(rel[0]))
    C = -_quat_to_rotmat_np(b["qvec"]).T @ b["tvec"]
    scale = max(np.linalg.norm(b["tvec"]),
                float(np.median(np.linalg.norm(X - C, axis=1))))
    return ang, float(np.linalg.norm(a["tvec"] - b["tvec"]) / scale)


def unexplained(np, a, b, q, max_error_px=12.0):
    """How many of result ``b``'s inliers the pose of result ``a`` leaves
    above the inlier threshold."""
    from pixsfm_tpu_torch.localization.pnp import _reproj_errors
    err = _reproj_errors(q["camera"], a["qvec"], a["tvec"], q["points3D"],
                         q["points2D"])
    return int((b["inliers"] & ~(err < max_error_px)).sum())


def ring_scene(np, n_views=12, n_points=300, W=1024, H=768, seed=42):
    """The ring of ``tests/test_mapper_scale.py`` at ``n_views`` views and
    ``n_points`` points: SIMPLE_RADIAL f = 1000, k = 0.02, keypoints with
    N(0, 0.3 px) noise, exhaustive matches of score 1. Returns (graph,
    keypoints, {name: blank image} for the image sizes)."""
    from pixsfm_tpu_torch.base.graph import Graph
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n_points, 3))
    xyz[:, 2] *= 0.6
    names = [f"im{i:02d}.png" for i in range(n_views)]
    keypoints, kp_of = {}, {}
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n_views, endpoint=False)):
        c = np.array([3.5 * np.cos(a), 0.5 * np.sin(2 * a), 3.5 * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        xc = (xyz - c) @ R.T
        uv = xc[:, :2] / xc[:, 2:]
        xy = 1000.0 * uv * (1 + 0.02 * (uv ** 2).sum(1))[:, None] \
            + [W / 2, H / 2]
        vis = (xc[:, 2] > 0.5) & (xy > 10).all(1) & (xy < [W - 10, H - 10]
                                                      ).all(1)
        idx = np.nonzero(vis)[0]
        keypoints[names[i]] = xy[idx] + rng.normal(0, 0.3, (len(idx), 2))
        kp_of[names[i]] = {int(p): j for j, p in enumerate(idx)}
    graph = Graph()
    for a in range(n_views):
        for b in range(a + 1, n_views):
            na, nb = names[a], names[b]
            shared = sorted(set(kp_of[na]) & set(kp_of[nb]))
            if len(shared) >= 30:
                m = np.asarray([[kp_of[na][p], kp_of[nb][p]] for p in shared])
                graph.register_matches(na, nb, m, np.ones(len(m)))
    sizes = {n: np.zeros((H, W, 3), np.uint8) for n in names}
    return graph, keypoints, sizes


def aligned_errors(np, rec, ref, ids=None):
    """Rotation errors (degrees) and camera-centre errors (fractions of the
    extent of ``ref``'s centres) of ``rec``'s images ``ids`` after the
    similarity (Umeyama) that maps their centres onto ``ref``'s."""
    ids = sorted(ids if ids is not None else
                 (i for i, im in rec.images.items() if im.registered))
    C = [np.stack([r.images[i].projection_center() for i in ids])
         for r in (rec, ref)]
    ma, mb = C[0].mean(0), C[1].mean(0)
    U, S, Vt = np.linalg.svd((C[1] - mb).T @ (C[0] - ma) / len(ids))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((C[0] - ma) ** 2).sum(1).mean()
    t = mb - s * R @ ma
    ext = np.linalg.norm(C[1] - mb, axis=1).max()
    rot = [np.degrees(np.arccos(np.clip((np.trace(
        ref.images[i].rotation_matrix()
        @ (rec.images[i].rotation_matrix() @ R.T).T) - 1) / 2, -1, 1)))
        for i in ids]
    cen = np.linalg.norm((s * C[0] @ R.T + t) - C[1], axis=1) / ext
    return np.asarray(rot), cen


FOLD_SLOPE = 0.5


def make_fold_scene(torch, np, seed, n_views, n_points, W, H, device,
                    min_track=3, max_track=8, margin=24, noise_px=0.5):
    """A non-planar scene: the valley z = -FOLD_SLOPE |x| (two planes meeting
    at x = 0), textured by 3-D position (8 plane waves of 20-100 cycles per
    unit), seen by ``n_views`` SIMPLE_RADIAL cameras of focal W (1.8-2.4
    units away on a ring, tilted 10-35 degrees). The views are ray-cast on
    ``device``; each point's track is a random subset of ``min_track``-
    ``max_track`` of the views that see it unoccluded (``margin`` px inside
    the image), its keypoints the true projections plus N(0, ``noise_px``).
    Returns ({name: [H, W, 3] uint8}, the true reconstruction, whose images
    hold the keypoints)."""
    from pixsfm_tpu_torch.base.cameras import Camera
    from pixsfm_tpu_torch.base.geometry import rotmat_to_quat_np
    from pixsfm_tpu_torch.base.projection import project_np
    from pixsfm_tpu_torch.sfm.model import Image, Point3D, Reconstruction
    rng = np.random.default_rng(seed)
    f = float(W)
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, 0.0])
    poses = []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        tilt = rng.uniform(0.17, 0.61)
        target = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                           -0.2])
        eye = target + rng.uniform(1.8, 2.4) * np.array(
            [np.sin(tilt) * np.cos(ang), np.sin(tilt) * np.sin(ang),
             np.cos(tilt)])
        R = _look_at(np, eye, target)
        poses.append((R, -R @ eye))

    n_waves = 8
    kdir = rng.normal(0, 1, (n_waves, 3))
    kvec = kdir / np.linalg.norm(kdir, axis=1, keepdims=True) \
        * rng.uniform(20, 100, (n_waves, 1))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    mix = rng.normal(0, 1, (n_waves, 3))
    mix *= 55.0 / np.sqrt((mix ** 2).sum(0))
    dev = torch.device(device)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    d_cam = torch.stack([(xs + 0.5 - W / 2) / f, (ys + 0.5 - H / 2) / f,
                         torch.ones_like(xs)], -1)
    kv = torch.as_tensor(kvec, device=dev)
    images = {}
    for v, (R, t) in enumerate(poses):
        d = d_cam @ torch.as_tensor(R, device=dev)     # world rays R^T d_cam
        C = torch.as_tensor(-R.T @ t, device=dev)
        best = torch.full((H, W), float("inf"), dtype=torch.float64,
                          device=dev)
        P = torch.zeros((H, W, 3), dtype=torch.float64, device=dev)
        for sgn in (-1.0, 1.0):                 # planes z + slope sgn x = 0
            n = torch.tensor([FOLD_SLOPE * sgn, 0.0, 1.0], dtype=torch.float64,
                             device=dev)
            s = -(C @ n) / (d @ n)
            p = C + s[..., None] * d
            ok = (s > 0) & (sgn * p[..., 0] >= 0) & (s < best)
            best = torch.where(ok, s, best)
            P = torch.where(ok[..., None], p, P)
        img = torch.full((H, W, 3), 127.5, dtype=torch.float64, device=dev)
        for k in range(n_waves):
            wave = torch.sin(2 * np.pi * (P @ kv[k]) + phase[k])
            img += wave[..., None] * torch.as_tensor(mix[k], device=dev)
        images[f"view{v:03d}.png"] = img.clamp(0, 255).to(torch.uint8) \
            .cpu().numpy()

    n_cand = 3 * n_points
    x = rng.uniform(-0.8, 0.8, n_cand)
    P3 = np.stack([x, rng.uniform(-0.8, 0.8, n_cand),
                   -FOLD_SLOPE * np.abs(x)], 1)
    vis = np.zeros((n_cand, n_views), bool)
    proj = np.zeros((n_cand, n_views, 2))
    for v, (R, t) in enumerate(poses):
        xy, z = project_np(cam, rotmat_to_quat_np(R), t, P3)
        # occluded when the segment camera -> point meets the other plane
        C = -R.T @ t
        seg = P3 - C
        sgn = -np.sign(P3[:, 0])
        n = np.stack([FOLD_SLOPE * sgn, np.zeros(n_cand), np.ones(n_cand)], 1)
        den = (seg * n).sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = -(n @ C) / den
        hit = C + s[:, None] * seg
        occl = (s > 0) & (s < 1 - 1e-9) & (sgn * hit[:, 0] >= 0)
        proj[:, v] = xy
        vis[:, v] = (z > 0) & ~occl & (xy[:, 0] >= margin) \
            & (xy[:, 0] < W - margin) & (xy[:, 1] >= margin) \
            & (xy[:, 1] < H - margin)
    keep = np.nonzero(vis.sum(1) >= min_track)[0][:n_points]
    if len(keep) < n_points:
        raise SystemExit(f"fold scene: only {len(keep)} points seen by "
                         f"{min_track} views")
    P3, vis, proj = P3[keep], vis[keep], proj[keep]
    L = np.minimum(rng.integers(min_track, max_track + 1, n_points),
                   vis.sum(1))
    keys = np.where(vis, rng.random(vis.shape), np.inf)
    chosen = np.argsort(keys, axis=1)
    in_track = np.zeros_like(vis)
    rows = np.repeat(np.arange(n_points), L)
    in_track[rows, chosen[rows, np.concatenate([np.arange(k) for k in L])]] \
        = True
    truth = Reconstruction()
    truth.add_camera(cam)
    tracks = [[] for _ in range(n_points)]
    for v, (R, t) in enumerate(poses):
        pts = np.nonzero(in_track[:, v])[0]
        xy = proj[pts, v] + rng.normal(0, noise_px, (len(pts), 2))
        for j, p in enumerate(pts):
            tracks[p].append((v + 1, j))
        truth.add_image(Image(v + 1, f"view{v:03d}.png", 1,
                              rotmat_to_quat_np(R), t, xy, pts))
    for p in range(n_points):
        truth.add_point3D(Point3D(p, P3[p], track=tracks[p]))
    return images, truth


# ---------------------------------------------------------------------------
# phase 18: query localization
# ---------------------------------------------------------------------------

LOC_VIEWS, LOC_QUERIES = 32, 8
LOC_PAIRS = 10             # retrieval pairs per query
LOC_WRONG = 0.2            # share of each query's matches to a wrong point
# cuda against cpu: two queries with QBA capped at this many steps on both
# devices (100 Newton steps on the card machine's CPU take ~1.5 min a query)
LOC_CPU_QBA_STEPS = 10
# Two runs of the localizer that draw different RANSAC samples (the serial
# path draws per query, localize_batch per size group; cuda and cpu round
# differently) may return different tied minimal-sample poses: with 1 px
# noise and the 12 px threshold hundreds of hypotheses tie at the full
# consensus, and the f64 polish is dropped when it loses one inlier (0.58
# against 0.69 degrees off the truth on one query, NVIDIA H100 80GB HBM3,
# 700 W). QBA pulls both in but does not merge them in 100 steps. So the
# two are held to consensus and to phase 14's polished-pose limits, and the
# tighter limits of the tests (the JAX package's batch test scaled to the
# scene, the CPU parity tests' 1e-4) are printed as counts of queries that
# meet them.
LOC_BATCH_LIMITS = (1e-3, 1.3e-3)    # rad, centre / extent


def localization_scene(torch, np, seed):
    """Phase 16's valley seen by ``LOC_VIEWS`` 1600x1200 views; every 4th
    view is a held-out query. Returns (decoded views, the reference model
    of the other views at their true poses, queries [(name, camera)], the
    queries' keypoints (true projections plus N(0, 1 px); the model's carry
    N(0, 0.5 px)), retrieval pairs and matches, the true poses of the
    queries, the scene's extent)."""
    views, truth = make_fold_scene(
        torch, np, seed=seed, n_views=LOC_VIEWS, n_points=RECON_POINTS,
        W=1600, H=1200, device="cuda", noise_px=0.5)
    rng = np.random.default_rng(seed + 1)
    qids = [i for i in sorted(truth.images) if i % 4 == 0]
    rec = truth.copy()
    for iid in qids:
        del rec.images[iid]
    for pid in list(rec.points3D):
        p = rec.points3D[pid]
        p.track = [(i, j) for (i, j) in p.track if i not in qids]
        if len(p.track) < 2:
            del rec.points3D[pid]
    for im in rec.images.values():
        keep = np.isin(im.point3D_ids, list(rec.points3D))
        im.point3D_ids = np.where(keep, im.point3D_ids, -1)
    centre = {i: im.projection_center() for i, im in truth.images.items()}
    queries, keypoints, pairs, matches, gt = [], {}, [], {}, {}
    for qid in qids:
        q = truth.images[qid]
        keypoints[q.name] = q.xys + rng.normal(0, np.sqrt(1.0 - 0.25),
                                               q.xys.shape)
        queries.append((q.name, truth.cameras[q.camera_id]))
        gt[q.name] = (q.qvec, q.tvec)
        near = sorted(rec.images, key=lambda i: np.linalg.norm(
            centre[i] - centre[qid]))[:LOC_PAIRS]
        for rid in near:
            r = rec.images[rid]
            slot = {int(p): j for j, p in enumerate(r.point3D_ids) if p >= 0}
            m = np.asarray([(j, slot[int(p)])
                            for j, p in enumerate(q.point3D_ids)
                            if int(p) in slot], np.int64).reshape(-1, 2)
            wrong = rng.random(len(m)) < LOC_WRONG
            m[wrong, 1] = rng.integers(0, len(r.xys), int(wrong.sum()))
            pairs.append((q.name, r.name))
            matches[(q.name, r.name)] = m
    P3 = np.stack([p.xyz for p in truth.points3D.values()])
    ref_views = {rec.images[i].name: views[rec.images[i].name]
                 for i in rec.images}
    return (views, ref_views, rec, queries, keypoints, pairs, matches, gt,
            float(np.ptp(P3, 0).max()))


def pose_error(np, qvec, tvec, gt):
    """(rotation error in degrees, camera-centre distance) to a true pose."""
    from pixsfm_tpu_torch.base.geometry import quat_to_rotmat_np
    R, Rg = quat_to_rotmat_np(qvec), quat_to_rotmat_np(gt[0])
    ang = np.degrees(np.arccos(np.clip((np.trace(R @ Rg.T) - 1) / 2, -1, 1)))
    return float(ang), float(np.linalg.norm(-R.T @ tvec + Rg.T @ gt[1]))


def compare_localizations(np, a, b, points3D, extent, tight):
    """Two runs over the same queries: the same successes, inlier counts
    within 2, poses within phase 14's polished limits (``pose_agreement``,
    ``PNP_POLISHED_TOL``); also how many poses meet ``tight`` (rotation in
    rad, centre distance over ``extent``)."""
    worst_n, worst_r, worst_t, n, n_tight = 0, 0.0, 0.0, 0, 0
    same = True
    for ra, rb, X in zip(a, b, points3D):
        if bool(ra.get("success")) != bool(rb.get("success")):
            same = False
            continue
        if not ra.get("success"):
            continue
        n += 1
        worst_n = max(worst_n, abs(ra["num_inliers"] - rb["num_inliers"]))
        ang, dt = pose_agreement(np, ra, rb, np.asarray(X))
        worst_r, worst_t = max(worst_r, ang), max(worst_t, dt)
        _, cen = pose_error(np, ra["qvec"], ra["tvec"],
                            (rb["qvec"], rb["tvec"]))
        n_tight += int(ang <= tight[0] and cen / extent <= tight[1])
    ok = same and worst_n <= 2 and max(worst_r, worst_t) <= PNP_POLISHED_TOL
    text = (f"the same successes: {same}; inlier counts within {worst_n}, "
            f"rotations within {worst_r:.2e} rad, translations within "
            f"{worst_t:.2e} relative (limits 2, {PNP_POLISHED_TOL:g}, "
            f"{PNP_POLISHED_TOL:g})")
    return dict(ok=ok, same=same, worst_n=worst_n, n=n, tight=n_tight,
                text=text)


def _stage_timers(sync, loc, main_mod):
    """Wrap the stages of ``QueryLocalizer.localize`` in wall-clock timers
    that end with ``sync()``; returns (times, the PnP results in call
    order, restore)."""
    times = {k: 0.0 for k in ("query extraction", "nearest references",
                              "QKA", "PnP", "QBA")}
    pnp_poses = []              # the PnP result of each query, in order

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            times[key] += time.perf_counter() - t0
            if fn.__name__ == "finalize_device_pose":
                pnp_poses.append(dict(out))
            elif fn.__name__ == "absolute_pose_estimation_batch":
                pnp_poses.append(dict(out[0]))
            return out
        return run

    saved = {n: getattr(main_mod, n) for n in (
        "_run_target_chunk", "_pnp_core", "absolute_pose_estimation_batch",
        "finalize_device_pose")}
    saved_loc = {n: getattr(loc, n) for n in ("extract_query_fmaps",
                                              "get_query_references")}
    saved_qba = loc.qba.refine_multilevel
    main_mod._run_target_chunk = timed("QKA", saved["_run_target_chunk"])
    for n in ("_pnp_core", "absolute_pose_estimation_batch",
              "finalize_device_pose"):
        setattr(main_mod, n, timed("PnP", saved[n]))
    loc.extract_query_fmaps = timed("query extraction",
                                    saved_loc["extract_query_fmaps"])
    loc.get_query_references = timed("nearest references",
                                     saved_loc["get_query_references"])
    loc.qba.refine_multilevel = timed("QBA", saved_qba)

    def restore():
        for n, fn in saved.items():
            setattr(main_mod, n, fn)
        for n, fn in saved_loc.items():
            setattr(loc, n, fn)
        loc.qba.refine_multilevel = saved_qba
    return times, pnp_poses, restore


def _pnp_hook(np, modules):
    """Record each ``finalize_device_pose`` call of ``modules`` (the fused
    path's and the staged RANSAC's): the correspondences it was given,
    its result, and whether that result kept the f64 polish (else it is
    the RANSAC pose, normalized). Returns (records, restore)."""
    calls = []
    saved = [(m, m.finalize_device_pose) for m in modules]
    fn = saved[0][1]

    def run(cam, qvec, tvec, inliers, num_inliers, xy, X, *a, **kw):
        out = fn(cam, qvec, tvec, inliers, num_inliers, xy, X, *a, **kw)
        q0 = np.asarray(qvec, np.float64)
        q0 = q0 / np.linalg.norm(q0)
        calls.append(dict(out, points2D=np.asarray(xy), points3D=X,
                          camera=cam, polished=bool(out["success"]) and not
                          np.array_equal(out["qvec"], q0)))
        return out
    for m, _ in saved:
        m.finalize_device_pose = run

    def restore():
        for m, f in saved:
            m.finalize_device_pose = f
    return calls, restore


def localization_phase(torch, np, interpolate_cuda, profile_out=None):
    """Phase 18 (see the module docstring). Returns the K1 entry's
    launches, its figures at the QKA shape, its in-situ time, and the
    scene (``localization_scene``'s tuple, which phase 23 reuses)."""
    from pixsfm_tpu_torch.config import load_config
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap
    from pixsfm_tpu_torch.localization import QueryLocalizer
    from pixsfm_tpu_torch.localization import main as loc_main
    from pixsfm_tpu_torch.localization import pnp as pnp_mod
    from pixsfm_tpu_torch.localize import (build_query_correspondences,
                                           localize_queries)
    t0 = time.perf_counter()
    (views, ref_views, rec, queries, keypoints, pairs, matches, gt,
     extent) = localization_scene(torch, np, seed=18)
    sync = torch.cuda.synchronize
    n_corr = {q: len(build_query_correspondences(rec, q, pairs, matches)[0])
              for q, _ in queries}
    print(f"phase 18: scene of {len(ref_views)} model views + "
          f"{len(queries)} queries, {len(rec.points3D)} points in the "
          f"model, {min(n_corr.values())}-{max(n_corr.values())} "
          f"correspondences per query ({LOC_PAIRS} pairs, "
          f"{LOC_WRONG:.0%} wrong), made in {time.perf_counter() - t0:.1f} s")
    conf = load_config("default")

    # -- the localizer and the serial path the CLI takes, counted ------------
    sync()
    interpolate_cuda.launches = 0
    t0 = time.perf_counter()
    loc = QueryLocalizer(rec, conf, image_dir=ref_views, device="cuda")
    sync()
    t_refs = time.perf_counter() - t0
    times, pnp_poses, restore = _stage_timers(sync, loc, loc_main)
    t0 = time.perf_counter()
    serial = localize_queries(loc, queries, keypoints, pairs, matches,
                              image_dir=views)
    sync()
    wall_s = time.perf_counter() - t0
    launches = {"K1": interpolate_cuda.launches}
    restore()
    n_ok = sum(bool(r.get("success")) for r in serial.values())
    errs = {q: pose_error(np, r["qvec"], r["tvec"], gt[q])
            for q, r in serial.items() if r.get("success")}
    rot = max(e[0] for e in errs.values())
    cen = max(e[1] for e in errs.values()) / extent
    pnp_errs = [pose_error(np, r["qvec"], r["tvec"], gt[q])
                for (q, _), r in zip(queries, pnp_poses)
                if r.get("success")]
    qba_up = [q for q, r in serial.items() if r.get("success")
              and not r["QBA"]["final_cost"] <= r["QBA"]["initial_cost"]]
    rest = wall_s - sum(v for k, v in times.items()
                        if k != "query extraction")
    print(f"phase 18: localize_queries (serial, prefetch 2) {wall_s:.2f} s "
          f"for {len(queries)} queries ({len(queries) / wall_s:.3f} "
          f"queries/s); reference extraction {t_refs:.2f} s; stages "
          + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
          + f", the rest of the main thread {rest:.2f} s (query extraction "
          f"runs on the prefetch thread beside it); {n_ok} of {len(queries)} "
          f"localized, inliers "
          f"{sorted(r.get('num_inliers', 0) for r in serial.values())}; "
          f"after PnP rotations within "
          f"{max(e[0] for e in pnp_errs):.3f} deg, centres within "
          f"{max(e[1] for e in pnp_errs) / extent:.2e} of the extent; "
          f"after QBA rotations within {rot:.3f} deg, centres within "
          f"{cen:.2e} of the extent (limits 0.5 deg, 1e-2); QBA costs "
          + ", ".join(f"{r['QBA']['initial_cost']:.3f} -> "
                      f"{r['QBA']['final_cost']:.3f}"
                      for r in serial.values() if r.get("success"))
          + f"; launches (references and localize_queries) {launches}")
    if n_ok < len(queries) - 1:
        raise SystemExit(f"only {n_ok} of {len(queries)} queries localized")
    if not (rot < 0.5 and cen < 1e-2):
        raise SystemExit("a localized query is off the truth")
    if qba_up:
        raise SystemExit(f"QBA raised the cost of {qba_up}")
    if launches["K1"] <= 0:
        raise SystemExit("K1 did not launch on the localization path")

    # -- localize_batch against the serial path ------------------------------
    batch_in = []
    for qname, cam in queries:
        p2D, p3D = build_query_correspondences(rec, qname, pairs, matches)
        batch_in.append(dict(keypoints=keypoints[qname], pnp_point2D_idxs=p2D,
                             pnp_points3D_id=p3D, query_camera=cam,
                             image_path=views[qname]))
    sync()
    t0 = time.perf_counter()
    batched = loc.localize_batch(batch_in)
    sync()
    wall_b = time.perf_counter() - t0
    agree = compare_localizations(
        np, [serial[q] for q, _ in queries], batched,
        [[rec.points3D[p].xyz for p in b["pnp_points3D_id"]]
         for b in batch_in], extent, LOC_BATCH_LIMITS)
    print(f"phase 18: localize_batch {wall_b:.2f} s "
          f"({len(queries) / wall_b:.3f} queries/s); against the serial "
          f"path: {agree['text']}; the limits of the JAX package's batch "
          f"test scaled to the scene ({LOC_BATCH_LIMITS[0]:g} rad, "
          f"{LOC_BATCH_LIMITS[1]:g} of the extent) met by "
          f"{agree['tight']} of {agree['n']}")
    if not agree["ok"]:
        raise SystemExit("localize_batch disagrees with the serial path")

    # -- cuda against cpu on two queries -------------------------------------
    # The whole flow (QBA capped) on both devices, held as phase 14 holds
    # PnP: the two may return different tied RANSAC poses
    # (LOC_BATCH_LIMITS), so each device's PnP pose must explain all but
    # one of the other's inliers, and the PnP and final poses must agree
    # within PNP_POLISHED_TOL where both kept the f64 polish, else within
    # PNP_UNPOLISHED_TOL. The stages' numbers are held from identical
    # inputs: the nearest references and QKA from the same keypoints, QBA
    # (100 steps) from the serial run's PnP pose and inliers.
    from pixsfm_tpu_torch.localization import QueryBundleAdjuster
    short = load_config("default")
    short.localization.QBA.optimizer.solver.max_num_iterations = \
        LOC_CPU_QBA_STEPS
    devs = ("cuda", "cpu")
    locs = {d: QueryLocalizer(rec, short, references=loc.references,
                              device=d) for d in devs}
    qba_cpu = QueryBundleAdjuster(loc.qba.conf, device="cpu")
    walls = {d: 0.0 for d in devs}
    d_ref, d_kp, d_rot, d_t, qba_costs, lines = 0, 0.0, 0.0, 0.0, [], []
    bad = []
    for qi, (qname, cam) in enumerate(queries[:2]):
        p2D, p3D = build_query_correspondences(rec, qname, pairs, matches)
        X = np.asarray([rec.points3D[p].xyz for p in p3D])
        pts2D = keypoints[qname][np.asarray(p2D)]
        fm = loc.extract_query_fmaps(keypoints[qname], p2D, views[qname])
        maps = {"cuda": fm, "cpu": [FeatureMap(f.patches.cpu(),
                                               f.keypoint_ids(), f.corners,
                                               f.scale) for f in fm]}
        refs, kp, qba, out, pnp = {}, {}, {}, {}, {}
        for d in devs:
            calls, restore = _pnp_hook(np, (loc_main, pnp_mod))
            t0 = time.perf_counter()
            try:
                out[d] = locs[d].localize(keypoints[qname], p2D, p3D, cam,
                                          query_fmaps=maps[d])
                sync()
            finally:
                restore()
            walls[d] += time.perf_counter() - t0
            pnp[d] = calls[-1]
            refs[d] = locs[d].get_query_references(p3D, maps[d], pts2D, p2D)
            kp[d] = pts2D.copy()
            locs[d].qka.refine_multilevel(kp[d], maps[d], refs["cuda"], p2D)
            start = pnp_poses[qi]
            qba[d] = (loc.qba if d == "cuda" else qba_cpu).refine(
                start["qvec"], start["tvec"], cam, X, maps[d][0],
                refs["cuda"][0], inliers=start["inliers"], point2D_idxs=p2D)
        qba_costs.append(" / ".join(
            f"{qba[d]['initial_cost']:.3f} -> {qba[d]['final_cost']:.3f}"
            for d in devs))
        d_ref += sum(int(not np.array_equal(a, b)) for a, b in
                     zip(refs["cuda"][0], refs["cpu"][0]))
        d_kp = max(d_kp, float(np.abs(kp["cuda"] - kp["cpu"]).max()))
        ang, dt = pose_agreement(np, qba["cuda"], qba["cpu"], X)
        d_rot, d_t = max(d_rot, ang), max(d_t, dt)
        # the whole flow, held as phase 14 holds PnP
        a, b = pnp["cuda"], pnp["cpu"]
        same = (bool(a["success"]) == bool(b["success"])
                == bool(out["cuda"].get("success"))
                == bool(out["cpu"].get("success")))
        if not same:
            bad.append(f"{qname}: successes differ")
            continue
        if not a["success"]:
            lines.append(f"{qname}: fails on both")
            continue
        tol = (PNP_POLISHED_TOL if a["polished"] and b["polished"]
               else PNP_UNPOLISHED_TOL)
        n_pnp = abs(a["num_inliers"] - b["num_inliers"])
        n_fin = abs(out["cuda"]["num_inliers"] - out["cpu"]["num_inliers"])
        left = max(unexplained(np, a, b, b), unexplained(np, b, a, a))
        pnp_r, pnp_t = pose_agreement(np, a, b, X)
        fin_r, fin_t = pose_agreement(np, out["cuda"], out["cpu"], X)
        truth = {d: pose_error(np, r["qvec"], r["tvec"], gt[qname])
                 for d, r in pnp.items()}
        lines.append(
            f"{qname}: PnP inliers {a['num_inliers']} / {b['num_inliers']}, "
            f"polish kept {a['polished']} / {b['polished']}, off the truth "
            + " / ".join(f"{truth[d][0]:.3f} deg, {truth[d][1] / extent:.2e}"
                         f" of the extent" for d in devs)
            + f"; inliers one pose leaves out of the other's {left}; PnP "
            f"poses within {pnp_r:.2e} rad, {pnp_t:.2e} relative; final "
            f"inliers within {n_fin}, poses within {fin_r:.2e} rad, "
            f"{fin_t:.2e} relative (limits 1, 1, {tol:g}, {tol:g}, 2, "
            f"{tol:g}, {tol:g})")
        if not (n_pnp <= 1 and left <= 1 and n_fin <= 2
                and max(pnp_r, pnp_t, fin_r, fin_t) <= tol):
            bad.append(f"{qname}: PnP or final poses disagree")
    print(f"phase 18: two queries on cuda and cpu, the whole flow (QBA "
          f"capped at {LOC_CPU_QBA_STEPS} steps) {walls['cuda']:.2f} s / "
          f"{walls['cpu']:.2f} s (cuda / cpu): " + "; ".join(lines)
          + f"; from identical inputs: {d_ref} nearest references "
          f"differ (limit 0), QKA keypoints within {d_kp:.2e} px (limit "
          f"0.05, phase 4's: the LM's step test is 1e-5 of |kp|, 1e-2 px "
          f"here), QBA (100 steps; costs {', '.join(qba_costs)}) rotations "
          f"within {d_rot:.2e} rad, translations within {d_t:.2e} relative "
          f"(limits 1e-4, 1e-4)")
    if bad or not (d_ref == 0 and d_kp <= 0.05 and d_rot <= 1e-4
                   and d_t <= 1e-4):
        raise SystemExit(f"localization disagrees between cuda and cpu: "
                         f"{bad}")

    # -- launches of one QKA and one QBA call, under the profiler -------------
    qname, cam = queries[0]
    p2D, p3D = build_query_correspondences(rec, qname, pairs, matches)
    fm = loc.extract_query_fmaps(keypoints[qname], p2D, views[qname])
    pts2D = keypoints[qname][np.asarray(p2D)]
    refs = loc.get_query_references(p3D, fm, pts2D, p2D)
    prof = {"QKA": profile_stage(torch, lambda: loc.qka.refine_multilevel(
        pts2D.copy(), fm, refs, p2D))}
    qba10 = QueryBundleAdjuster({"optimizer": {"solver": {
        "max_num_iterations": 10}}}, device="cuda")
    res = serial[qname]
    X = [rec.points3D[p].xyz for p in p3D]
    prof["QBA (10 steps)"] = profile_stage(torch, lambda: qba10.refine(
        res["qvec"], res["tvec"], cam, X, fm[0], refs[0],
        inliers=res["inliers"], point2D_idxs=p2D))
    for stage, (_, t_p, busy_p, kern_p, tab_p) in prof.items():
        n_p = sum(c for _, c, _ in kern_p)
        print(f"phase 18 (under the profiler): one {stage} call on "
              f"{len(p2D)} correspondences {t_p:.3f} s wall, {busy_p:.4f} s "
              f"device busy (idle share {1 - busy_p / t_p:.3f}), {n_p} "
              f"kernel launches")
        if profile_out:
            with open(Path(profile_out) / "chip_smoke_profile.txt",
                      "a") as fh:
                fh.write(f"\n\n== localization: {stage} ==\n{tab_p}\n")
    in_situ = _in_situ(prof["QKA"][3], {"K1": "interp_kernel"}, launches)
    print(f"phase 18: in-situ device ms per launch {in_situ}")
    n_kp = len(fm[0])
    del loc, locs, fm
    torch.cuda.empty_cache()
    # K1 at this path's QKA shape: one query's correspondences over its
    # bf16 patches
    k1 = check_k1(torch, interpolate_cuda, n_patches=n_kp,
                  n_queries=len(p2D), dtypes=(torch.bfloat16,))
    return launches, k1, in_situ, (views, ref_views, rec, queries, keypoints,
                                   pairs, matches, gt, extent)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 19: the low_memory preset
# ---------------------------------------------------------------------------

# (b): the preset's points-only BA, LM iterations on each device
LOWMEM_CPU_BA_ITERATIONS = 10
# (b): the observation chunk of the same-device witness (8192 otherwise)
LOWMEM_WITNESS_CHUNK = 1024
# (c): LM iterations of costmap BA on phase 9's scene, kept at 8 (as
# BA_ITERATIONS) to hold phase 19 near 125 s (each takes 0.8-1.7 s of
# host), and of its profiled run (tabulating the profile of one LM
# iteration, ~200 000 launches, takes ~30 s)
LOWMEM_BA_ITERATIONS = 8
# 19(d)'s points-only costmap BA on phase 11's scene (100 LM iterations as
# shipped, 18.58 s on an NVIDIA H100 80GB HBM3 at 700 W; cut to make room
# for phase 23)
LOWMEM_TRI_BA_ITERATIONS = 30
LOWMEM_PROFILE_ITERATIONS = 1


def feature_set_on(fset, device):
    """A copy of a sparse FeatureSet with its patches on ``device``."""
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap, FeatureSet
    out = FeatureSet(fset.channels, fset.patch_size, fset.dtype)
    for name, m in fset.maps.items():
        out.emplace(name, FeatureMap(
            m.patches.to(device), m.keypoint_ids(), m.corners, m.scale,
            upsampling_factor=m.upsampling_factor))
    return out


def costmaps_cuda_vs_cpu(torch, np, PixSfM, load_config):
    """Phase 19(b): costmap extraction and the preset's costmap BA on the
    card against the CPU, from identical inputs (phase 12's small scene)."""
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    from pixsfm_tpu_torch.bundle_adjustment import CostMapBundleAdjuster
    from pixsfm_tpu_torch.bundle_adjustment.costmaps import (
        costmap_solve, extract_costmaps)
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    rec, views, _ = make_ba_scene(torch, np, seed=13, n_views=12,
                                  n_points=1500, W=640, H=480,
                                  device="cuda", min_track=3, max_track=3)

    def preset(inner):
        return load_config("low_memory", extra={"mapping": {"BA": {
            "optimizer": {"solver": {
                "max_num_iterations": LOWMEM_CPU_BA_ITERATIONS,
                "use_inner_iterations": inner}}}}})

    class Rechunked(CostMapBundleAdjuster):
        """The same solve with another observation chunk: only the
        summation order of the normal equations changes."""
        def _ba_options(self, **overrides):
            return super()._ba_options(obs_chunk=LOWMEM_WITNESS_CHUNK,
                                       **overrides)

    sfm = PixSfM(preset(True), device="cuda")
    fset = features_from_reconstruction(sfm.extractor, rec, views).fset(0)
    ba_conf = sfm.bundle_adjuster.conf
    interp = InterpolationConfig.from_conf(ba_conf.interpolation)
    n_obs = sum(len(m) for m in fset.maps.values())

    def stack(cset):
        return torch.cat([m.patches.float().cpu()
                          for m in cset.maps.values()])

    # each device extracts its own references (K1 on the card)
    c_cpu, c_dev = (extract_costmaps(rec, feature_set_on(fset, d),
                                     ba_conf.costmaps, ba_conf.references,
                                     interp)[0] for d in ("cpu", "cuda"))
    want = stack(c_cpu)
    scale = float(want.abs().max())
    err = float((stack(c_dev) - want).abs().max()) / scale
    print(f"phase 19(b): {len(views)} views, {len(rec.points3D)} points, "
          f"{n_obs} observations: cost patches cuda vs cpu {err:.2e} of "
          f"the largest value {scale:.4g} (limit 1e-5)")
    if not err <= 1e-5:
        raise SystemExit("costmap extraction: cuda and cpu disagree")

    confs = {True: ba_conf, False: PixSfM(
        preset(False), device="cuda").bundle_adjuster.conf}

    def solve(inner, device, cls=CostMapBundleAdjuster, nudge=False):
        r = rec.copy()
        if nudge:   # each starting coordinate one float32 step up
            for p in r.points3D.values():
                p.xyz = np.nextafter(p.xyz.astype(np.float32),
                                     np.float32(np.inf)).astype(np.float64)
        out = costmap_solve(cls(confs[inner], device=device), r,
                            feature_set_on(c_cpu, device))
        if not out["final_cost"] < out["initial_cost"]:
            raise SystemExit("costmap BA: the cost did not fall")
        return out, np.stack([r.points3D[p].xyz for p in sorted(r.points3D)])

    def gap(a, b):
        d = np.abs(a[1] - b[1]).max(axis=1)
        return (abs(a[0]["final_cost"] - b[0]["final_cost"])
                / abs(b[0]["final_cost"]), float(d.max()),
                float(np.median(d)), int((d > 1e-3).sum()))

    def show(g):
        return (f"cost rel {g[0]:.2e}, points max {g[1]:.2e} / median "
                f"{g[2]:.2e}, {g[3]} beyond 1e-3")

    for inner in (False, True):
        run = {d: solve(inner, d) for d in ("cuda", "cpu")}
        g = gap(run["cuda"], run["cpu"])
        o = run["cuda"][0]
        print(f"phase 19(b): points-only costmap BA, inner iterations "
              f"{'on (as shipped)' if inner else 'off'}, {o['iterations']} "
              f"LM iterations ({o['linear_solver']} step), the same cost "
              f"patches: cost {o['initial_cost']:.6f} -> cuda "
              f"{o['final_cost']:.6f} / cpu {run['cpu'][0]['final_cost']:.6f}"
              f"; cuda vs cpu {show(g)}")
        if not inner:
            # the tolerances of tests/test_torch_ba.py::
            # test_adjuster_refine_matches
            print("phase 19(b): limits without inner iterations: cost rtol "
                  "1e-4, points 1e-3")
            if not (g[0] <= 1e-4 and g[1] <= 1e-3):
                raise SystemExit("costmap BA: cuda and cpu disagree")
            continue
        # the witnesses, on each device: the same solve with another
        # observation chunk, and from starting points one float32 step
        # away. Rounding of that size parts a few near-singular points on
        # one device as across two (ROADMAP.md section 3). Held: the
        # median point within 1e-4 (a fault of one device would move most
        # points), and either cost rtol 1e-3 with at most 1 % of the
        # points beyond 1e-3, or no further apart than twice the farthest
        # witness
        wit = []
        for d in ("cuda", "cpu"):
            wit += [gap(solve(True, d, Rechunked), run[d]),
                    gap(solve(True, d, nudge=True), run[d])]
            print(f"phase 19(b): witness on {d}, obs_chunk "
                  f"{LOWMEM_WITNESS_CHUNK}: {show(wit[-2])}; points one "
                  f"float32 step away: {show(wit[-1])}")
        far = [max(w[k] for w in wit) for k in range(4)]
        n_max = len(rec.points3D) // 100
        print(f"phase 19(b): limits with inner iterations: median 1e-4, and "
              f"cost rtol 1e-3 with at most {n_max} points beyond 1e-3 or "
              f"within twice the farthest witness (cost {2 * far[0]:.2e}, "
              f"points {2 * far[1]:.2e}, {2 * far[3]} beyond 1e-3)")
        if not g[2] <= 1e-4 or not (
                (g[0] <= 1e-3 and g[3] <= n_max)
                or (g[0] <= 2 * far[0] and g[1] <= 2 * far[1]
                    and g[3] <= 2 * far[3])):
            raise SystemExit("costmap BA (inner iterations): cuda and cpu "
                             "disagree")


def costmap_extraction_timing(torch, n_obs, ps=8, C=128):
    """The chunked costmap extraction (``costmap_patches``, plain PyTorch)
    on the card at ``n_obs`` observations of bf16 ``ps x ps x C`` patches,
    timed with CUDA events, beside its bound (each patch read once, each
    cost patch written once)."""
    from pixsfm_tpu_torch.base.losses import make_loss
    from pixsfm_tpu_torch.bundle_adjustment.costmaps import costmap_patches
    gen = torch.Generator(device="cuda").manual_seed(5)
    patches = torch.randn((n_obs, ps, ps, C), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
    rows = torch.arange(n_obs, device="cuda")
    targets = torch.randn((n_obs, C), generator=gen, device="cuda")
    loss = make_loss({"name": "cauchy", "params": [0.25]})
    ms = _time_ms(lambda: costmap_patches(patches, rows, targets, loss,
                                          True), reps=3, warmup=1)
    bytes_ = n_obs * (ps * ps * C * 2 + C * 4 + 8 + ps * ps * 3 * 4)
    flops = n_obs * ps * ps * C * 16
    bound_ms, bound_by = _bound(bytes_, flops)
    del patches, targets
    torch.cuda.empty_cache()
    return ms, bound_ms, bound_by, bytes_


def true_projections(np, truth):
    """{view name: the true (noise-free) projection of each keypoint's
    point} of a scene of :func:`make_ba_scene`."""
    from pixsfm_tpu_torch.base.projection import project_np
    out = {}
    for im in truth.images.values():
        X = np.stack([truth.points3D[int(p)].xyz for p in im.point3D_ids])
        out[im.name], _ = project_np(truth.cameras[im.camera_id], im.qvec,
                                     im.tvec, X)
    return out


def low_memory_phase(torch, np, PixSfM, load_config, interpolate_cuda,
                     cg_cuda, schur_cuda, ba_scene, tri_scene, mem_peak_ba,
                     profile_out=None):
    """Phase 19: the ``low_memory`` preset. ``ba_scene``: phase 9's
    (reconstruction at its starting state, decoded views, truth);
    ``tri_scene``: phase 11's (reference model, views, keypoints, matches,
    scores, truth, the unrefined and the default config's point errors,
    the number of points); ``mem_peak_ba``: phase 9's peak device memory
    above its start (bytes). Returns the launches (path, (c), (d)), K1's
    figures at the preset's shape, the in-situ times of (c) and the
    phase's other figures."""
    import tempfile
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    t19 = time.perf_counter()
    rec_lowmem, views, truth = ba_scene
    (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
     err_tri, n_tri_pts) = tri_scene
    torch.cuda.empty_cache()
    costmaps_cuda_vs_cpu(torch, np, PixSfM, load_config)
    # (c) phase 9's scene: run_ba with costmaps, 8 px patches, poses free
    lm_conf = {"dense_features": {"patch_size": 8}, "mapping": {"BA": {
        "strategy": "costmaps", "optimizer": {"solver": {
            "max_num_iterations": LOWMEM_BA_ITERATIONS}}}}}
    sfm_lm = PixSfM(lm_conf, device="cuda")
    rec_lm_profile = rec_lowmem.copy()
    err0 = point_error(np, rec_lowmem, truth)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    mem_base_lm = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_lm = sfm_lm.run_ba(rec_lowmem, views)
    torch.cuda.synchronize()
    wall_lm = time.perf_counter() - t0
    mem_peak_lm = torch.cuda.max_memory_allocated() - mem_base_lm
    launches_lm_ba = {"K1": interpolate_cuda.launches,
                      "K2": cg_cuda.launches,
                      "K3a": schur_cuda.launches["matvec"],
                      "K3b": schur_cuda.launches["rhs"],
                      "K3c": schur_cuda.launches["backsub"]}
    ol = {k: v[0] for k, v in out_lm.items()}
    err1 = point_error(np, rec_lowmem, truth)
    med0, med1 = (float(np.median([np.linalg.norm(
        r.points3D[p].xyz - q.xyz) for p, q in truth.points3D.items()]))
        for r in (rec_lm_profile, rec_lowmem))
    n_far = sum(np.linalg.norm(rec_lowmem.points3D[p].xyz - q.xyz)
                > 10 * err0 for p, q in truth.points3D.items())
    t_ext_lm = wall_lm - ol["references_time"] - ol["costmap_time"] \
        - ol["time"]
    print(f"phase 19(c): run_ba (costmaps, 8 px patches, poses free) on "
          f"phase 9's scene {wall_lm:.2f} s (extraction + packing "
          f"{t_ext_lm:.2f} s, references {ol['references_time']:.2f} s, "
          f"costmap extraction {ol['costmap_time']:.2f} s, BA solve "
          f"{ol['time']:.2f} s), grid T {ol['obs_grid_T']}, LM iterations "
          f"{ol['iterations']}, CG iterations {ol['cg_iterations']}, cost "
          f"{ol['initial_cost']:.6f} -> {ol['final_cost']:.6f}, point error "
          f"to truth {err0:.5f} -> {err1:.5f} (median {med0:.5f} -> "
          f"{med1:.5f}; {n_far} points end over 10x the mean starting "
          f"error from the truth), launches {launches_lm_ba}; "
          f"peak device memory {mem_peak_lm / 1e9:.2f} GB above the "
          f"{mem_base_lm / 1e9:.2f} GB allocated before (feature_reference, "
          f"16 px, phase 9: {mem_peak_ba / 1e9:.2f} GB)")
    if not all(np.isfinite(im.qvec).all() and np.isfinite(im.tvec).all()
               for im in rec_lowmem.images.values()) or not all(
            np.isfinite(p.xyz).all() for p in rec_lowmem.points3D.values()):
        raise SystemExit("non-finite poses or points after costmap BA")
    if ol["obs_grid_T"] != 8:
        raise SystemExit(f"costmap BA did not take the grid regime: {ol}")
    if not ol["final_cost"] < ol["initial_cost"]:
        raise SystemExit("costmap BA cost did not fall")
    if min(launches_lm_ba[k] for k in ("K1", "K3a", "K3b", "K3c")) <= 0:
        raise SystemExit(f"a kernel did not launch on the costmap BA path: "
                         f"{launches_lm_ba}")
    # where its time goes (a second run, not counted)
    sfm_lm_prof = PixSfM({**lm_conf, "mapping": {"BA": {
        "strategy": "costmaps", "optimizer": {"solver": {
            "max_num_iterations": LOWMEM_PROFILE_ITERATIONS}}}}},
        device="cuda")
    fm_lm = features_from_reconstruction(sfm_lm_prof.extractor,
                                         rec_lm_profile, views)
    out_lp, t_lmp, busy_lmp, kern_lmp, tab_lmp = profile_stage(
        torch, lambda: sfm_lm_prof.bundle_adjuster.refine_multilevel(
            rec_lm_profile, fm_lm))
    del fm_lm
    print(f"phase 19(c) (under the profiler): references + costmaps + BA "
          f"({LOWMEM_PROFILE_ITERATIONS} LM iteration, "
          f"{out_lp['cg_iterations'][0]} CG iterations) {t_lmp:.3f} s wall, "
          f"{busy_lmp:.3f} s device busy (idle share "
          f"{1 - busy_lmp / t_lmp:.2f}); references "
          f"{out_lp['references_time'][0]:.3f} s, costmaps "
          f"{out_lp['costmap_time'][0]:.3f} s, BA solve "
          f"{out_lp['time'][0]:.3f} s")
    for name, calls, dev_ms in kern_lmp[:8]:
        print(f"  costmap BA: {dev_ms:9.3f} ms in {calls:6d} launches  "
              f"{name[:90]}")
    in_situ_lm = _in_situ(kern_lmp, {"K3a": "matvec_kernel",
                                     "K3b": "rhs_kernel",
                                     "K3c": "backsub_kernel",
                                     "K1": "interp_kernel"}, launches_lm_ba)
    print(f"phase 19(c): in-situ device ms per launch {in_situ_lm}")
    if profile_out:
        with open(Path(profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== low_memory: costmap BA "
                     f"({LOWMEM_PROFILE_ITERATIONS} LM iteration) ==\n"
                     f"{tab_lmp}\n")
    n_obs_lm = sum(p.track_length for p in rec_lowmem.points3D.values())
    del sfm_lm, sfm_lm_prof, rec_lowmem, rec_lm_profile, views, truth, \
        ba_scene
    torch.cuda.empty_cache()
    cm_ms, cm_bound, cm_bound_by, cm_bytes = costmap_extraction_timing(
        torch, n_obs_lm)
    print(f"phase 19(c): costmap extraction (chunked PyTorch, "
          f"{n_obs_lm} observations of bf16 8x8x128) {cm_ms:.3f} ms, bound "
          f"{cm_bound:.3f} ms ({cm_bound_by}, {cm_bytes / 1e9:.2f} GB)")
    # (a) K1 at the preset's shape: the references' one launch, one query
    # per observation of (c) over one bf16 8 px patch each
    k1_lm = check_k1(torch, interpolate_cuda, n_patches=n_obs_lm,
                     n_queries=n_obs_lm, dtypes=(torch.bfloat16,), ps=8)
    torch.cuda.empty_cache()
    # (d) the shipped preset end to end on phase 11's scene
    tmp19 = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    proj_t = true_projections(np, truth_t)
    names_t = sorted(kps_t)
    def kp_error(kps):
        return float(np.mean(np.concatenate([
            np.linalg.norm(kps[n] - proj_t[n], axis=1) for n in names_t])))

    kp_err0 = kp_error(kps_t)
    sfm_pre = PixSfM(load_config("low_memory", extra={"mapping": {"BA": {
        "optimizer": {"solver": {
            "max_num_iterations": LOWMEM_TRI_BA_ITERATIONS}}}}}),
        device="cuda")
    kps_d = {k: v.copy() for k, v in kps_t.items()}
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    rec_pre, out_pre = sfm_pre._triangulation(
        Path(tmp19.name) / "low_memory", reference, views_t, kps_d,
        matches_t, scores_t)
    torch.cuda.synchronize()
    wall_pre = time.perf_counter() - t0
    launches_lm_tri = {"K1": interpolate_cuda.launches,
                       "K2": cg_cuda.launches,
                       "K3a": schur_cuda.launches["matvec"],
                       "K3b": schur_cuda.launches["rhs"],
                       "K3c": schur_cuda.launches["backsub"]}
    tmp19.cleanup()
    pka = {k: v[0] for k, v in out_pre["KA"].items()}
    pba = {k: v[0] for k, v in out_pre["BA"].items()}
    kp_err1 = kp_error(kps_d)
    err_pre = triangulated_error(np, rec_pre, truth_t)
    print(f"phase 19(d): PixSfM(low_memory)._triangulation on phase 11's "
          f"scene {wall_pre:.2f} s (KA {pka['time']:.2f} s, "
          f"{pka['num_problems']} problems, {pka['iterations']} LM "
          f"iterations, cost {pka['initial_cost']:.4f} -> "
          f"{pka['final_cost']:.4f}; triangulation "
          f"{out_pre['triangulation']['time']:.2f} s, "
          f"{len(rec_pre.points3D)} points; BA references "
          f"{pba['references_time']:.2f} s, costmaps "
          f"{pba['costmap_time']:.2f} s, solve {pba['time']:.2f} s, "
          f"{pba['linear_solver']} step, grid T {pba['obs_grid_T']}, "
          f"{pba['iterations']} LM / {pba['cg_iterations']} CG iterations, "
          f"cost {pba['initial_cost']:.6f} -> {pba['final_cost']:.6f}); "
          f"keypoint error to the true projections {kp_err0:.3f} -> "
          f"{kp_err1:.3f} px; point error to truth {err_raw:.5f} "
          f"(unrefined keypoints) -> {err_pre:.5f} (default config, phase "
          f"11: {err_tri:.5f}); launches {launches_lm_tri}")
    if not all(np.isfinite(p.xyz).all() for p in rec_pre.points3D.values()):
        raise SystemExit("non-finite points on the low_memory path")
    if not (pka["final_cost"] < pka["initial_cost"]
            and pba["final_cost"] <= pba["initial_cost"]):
        raise SystemExit("low_memory: a cost did not rise or fall as it "
                         "should")
    if launches_lm_tri["K1"] <= 0:
        raise SystemExit("K1 did not launch on the low_memory path")
    if not len(rec_pre.points3D) >= TRI_MIN_SURVIVING * n_tri_pts:
        raise SystemExit("low_memory: too few tracks survived")
    launches_lm = {k: launches_lm_ba[k] + launches_lm_tri[k]
                   for k in launches_lm_ba}
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")
    return launches_lm, launches_lm_ba, launches_lm_tri, k1_lm, in_situ_lm


# ---------------------------------------------------------------------------
# phase 20: the photometric preset
# ---------------------------------------------------------------------------

# (b): LM iterations of the cuda / cpu patch-warp solves (the preset's 30
# would take ~1 min on the card machine's CPU)
PHOTO_CPU_BA_ITERATIONS = 5
# (d): LM iterations of run_ba with poses free (~1.1 s of host each)
PHOTO_BA_ITERATIONS = 10
# 20(c)'s patch-warp BA on phase 11's scene (30 LM iterations as shipped,
# 18.43 s for the 28 it ran on an NVIDIA H100 80GB HBM3 at 700 W; cut to
# 15 to make room for phase 23, and to 8 for phase 24)
PHOTO_TRI_BA_ITERATIONS = 8


def photometric_cuda_vs_cpu(torch, np, PixSfM, load_config, tmp):
    """Phase 20(b): phase 12's scene (12 views of 640x480, 1500 points with
    tracks of 3) with the photometric preset on ``cuda`` and on ``cpu``:
    the dense image-model maps equal, every observation's 16-node NCC
    descriptor within 1e-5 of the largest value, and ``patch_warp`` through
    ``refine_reconstruction`` with joint source poses (``refine_extrinsics``
    on: the dense step with ``src_idx``) and with constant ones (the preset)
    within phase 8's limits."""
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    from pixsfm_tpu_torch.bundle_adjustment.references import \
        extract_references
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    from pixsfm_tpu_torch.features.featuremaps import FeatureView
    rec, views, _ = make_ba_scene(torch, np, seed=13, n_views=12,
                                  n_points=1500, W=640, H=480,
                                  device="cuda", min_track=3, max_track=3)
    conf = load_config("photometric")
    sfm = {d: PixSfM(conf, device=d) for d in ("cuda", "cpu")}
    fsets = {d: features_from_reconstruction(sfm[d].extractor, rec,
                                             views).fset(0)
             for d in sfm}
    map_err = max(float((fsets["cuda"].maps[n].patches.cpu().float()
                         - m.patches.float()).abs().max())
                  for n, m in fsets["cpu"].maps.items())
    ba_conf = sfm["cuda"].bundle_adjuster.conf
    interp = InterpolationConfig.from_conf(ba_conf.interpolation)
    ref_conf = {**ba_conf.references.to_dict(), "keep_observations": True}
    pids = sorted(rec.points3D)
    refs = {d: extract_references(
        rec, fsets[d], FeatureView.from_reconstruction(fsets[d], rec, pids),
        ref_conf, interp, point3D_ids=pids) for d in sfm}
    want = np.concatenate([refs["cpu"][p].track_descriptors for p in pids])
    got = np.concatenate([refs["cuda"][p].track_descriptors for p in pids])
    scale = float(np.abs(want).max())
    ref_err = float(np.abs(got - want).max()) / scale
    same_src = sum(refs["cuda"][p].source == refs["cpu"][p].source
                   for p in pids)
    off_err = max(float(np.abs(refs["cuda"][p].node_offsets3D
                               - refs["cpu"][p].node_offsets3D).max())
                  for p in pids)
    n_obs = sum(len(p.track) for p in rec.points3D.values())
    print(f"phase 20(b): {len(views)} views, {len(pids)} points, {n_obs} "
          f"observations: dense maps ({tuple(fsets['cuda'].maps['view000.png'].patches.shape)} "
          f"bf16 each) max |cuda - cpu| = {map_err:.2e} (limit 0); "
          f"16-node NCC descriptors {ref_err:.2e} of the largest value "
          f"{scale:.4g} (limit 1e-5), sources equal for {same_src} / "
          f"{len(pids)}, 3D node offsets {off_err:.2e}")
    if not (map_err == 0.0 and ref_err <= 1e-5):
        raise SystemExit("photometric extraction or references: cuda and "
                         "cpu disagree")
    del fsets, refs
    src = Path(tmp) / "photometric_in"
    rec.write(src)
    for mode, extrinsics in (("joint", True), ("constant", False)):
        mode_conf = load_config("photometric", extra={"mapping": {"BA": {
            "optimizer": {"refine_extrinsics": extrinsics, "solver": {
                "max_num_iterations": PHOTO_CPU_BA_ITERATIONS}}}}})
        runs = {}
        for d in ("cuda", "cpu"):
            if d == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_rec, out = PixSfM(mode_conf, device=d).refine_reconstruction(
                Path(tmp) / f"photometric_{mode}_{d}", src, views)
            if d == "cuda":
                torch.cuda.synchronize()
            runs[d] = ({k: v[0] for k, v in out.items()}, np.stack(
                [out_rec.points3D[p].xyz for p in pids]),
                time.perf_counter() - t0)
        (o_d, x_d, w_d), (o_c, x_c, w_c) = runs["cuda"], runs["cpu"]
        dx = float(np.abs(x_d - x_c).max())
        print(f"phase 20(b): patch_warp ({mode} source poses) through "
              f"refine_reconstruction: regime {o_d['linear_solver']} / "
              f"{o_c['linear_solver']}, {o_d['iterations']} / "
              f"{o_c['iterations']} LM iterations, cost cuda "
              f"{o_d['initial_cost']:.6f} -> {o_d['final_cost']:.6f} / cpu "
              f"{o_c['final_cost']:.6f}, max |xyz(cuda) - xyz(cpu)| = "
              f"{dx:.2e} (limits: cost rtol 1e-4, xyz 1e-3); {w_d:.2f} s on "
              f"cuda (BA solve {o_d['time']:.3f} s), {w_c:.2f} s on cpu "
              f"(BA solve {o_c['time']:.3f} s)")
        if not (o_d["linear_solver"] == o_c["linear_solver"] == "dense"
                and o_d["joint_source_poses"] is extrinsics
                and o_c["joint_source_poses"] is extrinsics):
            raise SystemExit(f"photometric BA ({mode}): not the dense step "
                             f"in the {mode} mode")
        if not (abs(o_d["final_cost"] - o_c["final_cost"])
                <= 1e-4 * abs(o_c["final_cost"]) and dx <= 1e-3):
            raise SystemExit(f"photometric BA ({mode}): cuda and cpu "
                             f"disagree")
        if not o_d["final_cost"] < o_d["initial_cost"]:
            raise SystemExit(f"photometric BA ({mode}): the cost did not "
                             f"fall")


def pose_errors(np, rec, truth):
    """Mean rotation (degrees) and camera-centre errors of ``rec``'s poses
    against ``truth``'s."""
    rot, centre = [], []
    for iid, im in truth.images.items():
        R0, R1 = im.rotation_matrix(), rec.images[iid].rotation_matrix()
        cos = (np.trace(R0.T @ R1) - 1.0) / 2.0
        rot.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        centre.append(np.linalg.norm(R0.T @ im.tvec
                                     - R1.T @ rec.images[iid].tvec))
    return float(np.mean(rot)), float(np.mean(centre))


def photometric_phase(torch, np, PixSfM, load_config, interpolate_cuda,
                      cg_cuda, schur_cuda, tri_scene, profile_out=None):
    """Phase 20: the ``photometric`` preset. ``tri_scene``: phase 11's
    (reference model, views, keypoints, matches, scores, truth, the
    unrefined and the default config's point errors, the number of
    points). Returns the launches of (c) and (d), K1's figures at the
    path's shape and its in-situ time."""
    import tempfile
    from pixsfm_tpu_torch.base.geometry import (exp_quat_np, quat_mul,
                                                quat_normalize)
    t20 = time.perf_counter()
    (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
     err_tri, n_tri_pts) = tri_scene
    tmp20 = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp20.name)
    torch.cuda.empty_cache()
    photometric_cuda_vs_cpu(torch, np, PixSfM, load_config, tmp)

    def zero_counts():
        torch.cuda.synchronize()
        interpolate_cuda.launches = 0
        cg_cuda.launches = 0
        for name in schur_cuda.launches:
            schur_cuda.launches[name] = 0

    def read_counts():
        torch.cuda.synchronize()
        return {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                "K3a": schur_cuda.launches["matvec"],
                "K3b": schur_cuda.launches["rhs"],
                "K3c": schur_cuda.launches["backsub"]}

    # (c) the preset on phase 11's scene, its BA capped
    sfm = PixSfM(load_config("photometric", extra={"mapping": {"BA": {
        "optimizer": {"solver": {
            "max_num_iterations": PHOTO_TRI_BA_ITERATIONS}}}}}),
        device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    rec_p, out_p = sfm._triangulation(
        tmp / "photometric", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    launches_tri = read_counts()
    oba = {k: v[0] for k, v in out_p["BA"].items()}
    err_p = triangulated_error(np, rec_p, truth_t)
    t_rest = wall_p - out_p["triangulation"]["time"] - oba["time"]
    print(f"phase 20(c): PixSfM(photometric)._triangulation on phase 11's "
          f"scene {wall_p:.2f} s (no KA; dense extraction + packing + "
          f"references {t_rest:.2f} s, of which references "
          f"{oba['references_time']:.2f} s; triangulation "
          f"{out_p['triangulation']['time']:.2f} s, "
          f"{len(rec_p.points3D)} points; patch_warp BA solve "
          f"{oba['time']:.2f} s, {oba['num_residuals']} observations, "
          f"{oba['linear_solver']} step, joint source poses "
          f"{oba['joint_source_poses']}, {oba['iterations']} LM / "
          f"{oba['cg_iterations']} CG iterations, cost "
          f"{oba['initial_cost']:.6f} -> {oba['final_cost']:.6f}); point "
          f"error to truth {err_raw:.5f} before BA (the unrefined keypoints' "
          f"triangulation) -> {err_p:.5f} after it; the default config "
          f"(phase 11, KA and featuremetric BA on S2DNet): {err_tri:.5f}; "
          f"launches {launches_tri}")
    if not all(np.isfinite(p.xyz).all() for p in rec_p.points3D.values()):
        raise SystemExit("non-finite points on the photometric path")
    if not oba["final_cost"] < oba["initial_cost"]:
        raise SystemExit("photometric BA cost did not fall")
    if launches_tri["K1"] <= 0:
        raise SystemExit("K1 did not launch on the photometric path")
    if not len(rec_p.points3D) >= TRI_MIN_SURVIVING * n_tri_pts:
        raise SystemExit("photometric: too few tracks survived")
    # where its time goes: the path again under the profiler, BA capped at
    # BA_PROFILE_ITERATIONS (a second run, not counted)
    sfm_prof = PixSfM(load_config("photometric", extra={"mapping": {"BA": {
        "optimizer": {"solver": {
            "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}), device="cuda")
    (_, out_pp), t_pp, busy_pp, kern_pp, tab_pp = profile_stage(
        torch, lambda: sfm_prof._triangulation(
            tmp / "photometric_profile", reference, views_t,
            {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t))
    print(f"phase 20(c) (under the profiler, {BA_PROFILE_ITERATIONS} BA "
          f"iterations): {t_pp:.3f} s wall, {busy_pp:.3f} s device busy "
          f"(idle share {1 - busy_pp / t_pp:.2f}); references "
          f"{out_pp['BA']['references_time'][0]:.3f} s, BA solve "
          f"{out_pp['BA']['time'][0]:.3f} s")
    for name, calls, dev_ms in kern_pp[:10]:
        print(f"  photometric path: {dev_ms:9.3f} ms in {calls:6d} launches"
              f"  {name[:90]}")
    in_situ = _in_situ(kern_pp, {"K1": "interp_kernel"}, launches_tri)
    print(f"phase 20(c): in-situ device ms per launch {in_situ}")
    if profile_out:
        with open(Path(profile_out) / "chip_smoke_profile.txt", "a") as fh:
            fh.write(f"\n\n== photometric triangulation path "
                     f"({BA_PROFILE_ITERATIONS} BA iterations) ==\n"
                     f"{tab_pp}\n")
    # (d) run_ba with patch_warp and poses free (joint source poses, the
    # flat CG layout) on (c)'s model, its poses perturbed
    rec_d = rec_p.copy()
    rng = np.random.default_rng(20)
    for iid in sorted(rec_d.images)[1:]:
        im = rec_d.images[iid]
        dq = torch.as_tensor(exp_quat_np(rng.normal(0, 3e-4, 3)))
        im.qvec = quat_normalize(quat_mul(dq, torch.as_tensor(
            im.qvec))).numpy()
        im.tvec = im.tvec + rng.normal(0, 1e-3, 3)
    rot0, cen0 = pose_errors(np, rec_d, truth_t)
    err_d0 = triangulated_error(np, rec_d, truth_t)
    sfm_j = PixSfM(load_config("photometric", extra={"mapping": {"BA": {
        "optimizer": {"refine_extrinsics": True, "solver": {
            "max_num_iterations": PHOTO_BA_ITERATIONS}}}}}), device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    out_j = sfm_j.run_ba(rec_d, views_t)
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    launches_ba = read_counts()
    oj = {k: v[0] for k, v in out_j.items()}
    rot1, cen1 = pose_errors(np, rec_d, truth_t)
    err_d1 = triangulated_error(np, rec_d, truth_t)
    print(f"phase 20(d): run_ba (patch_warp, poses free) on (c)'s model, "
          f"poses perturbed: {wall_j:.2f} s (references "
          f"{oj['references_time']:.2f} s, BA solve {oj['time']:.2f} s), "
          f"{oj['linear_solver']} step, grid T {oj['obs_grid_T']}, joint "
          f"source poses {oj['joint_source_poses']}, {oj['iterations']} LM "
          f"/ {oj['cg_iterations']} CG iterations, cost "
          f"{oj['initial_cost']:.6f} -> {oj['final_cost']:.6f}; poses to "
          f"truth {rot0:.4f} -> {rot1:.4f} deg, centres {cen0:.5f} -> "
          f"{cen1:.5f}; points {err_d0:.5f} -> {err_d1:.5f}; launches "
          f"{launches_ba}")
    if not (oj["joint_source_poses"] and oj["linear_solver"] == "cg"
            and oj["obs_grid_T"] == 0):
        raise SystemExit("photometric run_ba did not take the joint mode "
                         "on the flat CG layout")
    if not oj["final_cost"] < oj["initial_cost"]:
        raise SystemExit("photometric run_ba cost did not fall")
    if not all(np.isfinite(im.qvec).all() and np.isfinite(im.tvec).all()
               for im in rec_d.images.values()):
        raise SystemExit("non-finite poses after photometric run_ba")
    if launches_ba["K1"] <= 0:
        raise SystemExit("K1 did not launch in photometric run_ba")
    n_obs = int(oba["num_residuals"])
    del sfm, sfm_prof, sfm_j, rec_p, rec_d
    tmp20.cleanup()
    torch.cuda.empty_cache()
    # (a) K1 at the path's shape: one BA chunk (8192 observations) of node
    # queries, 16 per observation, over one bf16 16x16x3 window each, L2
    # off (the general variant: 3 channels)
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    nodes = InterpolationConfig.from_conf(
        load_config("photometric").interpolation).nodes
    k1 = check_k1(torch, interpolate_cuda, n_patches=n_obs,
                  n_queries=8192 * len(nodes), dtypes=(torch.bfloat16,),
                  C=3, l2=False, variant="general", nodes=nodes)
    launches = {k: launches_tri[k] + launches_ba[k] for k in launches_tri}
    print(f"phase 20: {time.perf_counter() - t20:.1f} s")
    return launches, launches_tri, launches_ba, k1, in_situ


# ---------------------------------------------------------------------------
# phase 21: the ETH3D evaluation flow
# ---------------------------------------------------------------------------

def detector_agreement(np, a, b, stride=1, offset=0.0):
    """cuda against cpu ``detect`` results, keypoints keyed by their
    detection cell ``rint((xy - offset) / stride)`` (SuperPoint and R2D2
    detect on pixels; D2-Net on stride-4 cells mapped back as 4 p + 1.5,
    then moved by its sub-pixel Newton step). The cell sets must be equal
    outside score ties (a cell found on one device only must carry the
    smallest valid score, tied at the top-k boundary). On the common cells:
    the largest position difference, the largest score difference relative
    to the largest score, and the largest descriptor difference over the
    cells whose positions agree within 1e-3 px (``far`` counts the others:
    a descriptor sampled elsewhere is another descriptor)."""
    def keyed(o):
        v = o["valid"][0]
        kp, sc, de = (o[k][0][v] for k in ("keypoints", "scores",
                                           "descriptors"))
        cells = np.rint((kp - offset) / stride).astype(np.int64)
        return {tuple(c): (k, s, d) for c, k, s, d in zip(cells, kp, sc, de)}

    A, B = keyed(a), keyed(b)
    common = sorted(set(A) & set(B))
    scores = [s for _, s, _ in list(A.values()) + list(B.values())]
    floor = min(scores) if scores else 0.0
    untied = [c for c in set(A) ^ set(B)
              if abs((A.get(c) or B.get(c))[1] - floor)
              > 1e-5 * max(abs(floor), 1e-12)]
    pos = [float(np.abs(A[c][0] - B[c][0]).max()) for c in common]
    close = [c for c, d in zip(common, pos) if d <= 1e-3]
    top = max((abs(s) for s in scores), default=1.0)
    return dict(
        n_cuda=len(A), n_cpu=len(B), common=len(common), untied=len(untied),
        pos=max(pos, default=0.0), far=len(common) - len(close),
        score_rel=max((abs(A[c][1] - B[c][1]) / top for c in common),
                      default=0.0),
        desc=max((float(np.abs(A[c][2] - B[c][2]).max()) for c in close),
                 default=0.0))


def kernel_counts(torch, interpolate_cuda, cg_cuda, schur_cuda):
    """(zero, read): set every kernel's launch count to 0 / read them all,
    each after the queued work has finished."""
    def zero():
        torch.cuda.synchronize()
        interpolate_cuda.launches = 0
        interpolate_cuda.launches_by_channels.clear()
        cg_cuda.launches = 0
        for name in schur_cuda.launches:
            schur_cuda.launches[name] = 0

    def read():
        torch.cuda.synchronize()
        return {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                "K3a": schur_cuda.launches["matvec"],
                "K3b": schur_cuda.launches["rhs"],
                "K3c": schur_cuda.launches["backsub"]}

    return zero, read


def make_eth3d_scene(tmp):
    """Phases 21 and 22's scene under ``tmp / "scene"``: its ground truth."""
    from pixsfm_tpu_torch.eval.eth3d.synthetic import make_synthetic_scene
    t0 = time.perf_counter()
    gt = make_synthetic_scene(tmp / "scene", n_images=ETH3D_VIEWS,
                              n_points=ETH3D_POINTS, seed=5, width=1600,
                              height=1200, patch=ETH3D_PATCH)
    print(f"phase 21: synthetic ETH3D scene of {len(gt.images)} rendered "
          f"1600x1200 views, {len(gt.points3D)} points with {ETH3D_PATCH} "
          f"px textures, made in {time.perf_counter() - t0:.1f} s")
    return gt


def eth3d_phase(torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
                schur_cuda, scene, gt, profile_out=None):
    """Phase 21: the ETH3D evaluation flow on the rendered synthetic
    ``scene`` (ground truth ``gt``). Returns the launches of (b)+(c) on
    patches, K1's launches in (c) on the queries' dense maps and K1's
    figures there, the launches of (d) and of (d) by channel count, and
    the in-situ device ms per launch of K1 / K2 in (b) and of K1 per
    channel count in (d)."""
    import tempfile

    from pixsfm_tpu_torch.eval.eth3d.localization import \
        run_scene_localization
    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene
    from pixsfm_tpu_torch.features.detectors import load_rgb
    from pixsfm_tpu_torch.features.models import get_model
    t21 = time.perf_counter()
    tmp21 = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp21.name)
    torch.cuda.empty_cache()
    zero_counts, read_counts = kernel_counts(torch, interpolate_cuda,
                                             cg_cuda, schur_cuda)

    # (a) the detectors at full width on one view, then cuda against cpu
    # on a 640x480 crop of it
    view, _ = load_rgb(scene / "images" / sorted(
        im.name for im in gt.images.values())[0], 1600)
    # padded to a multiple of 64 rows, as detect_directory pads
    full = torch.zeros((1, 1216, 1600, 3), device="cuda")
    full[0, :1200] = torch.as_tensor(view, device="cuda")
    crop = np.ascontiguousarray(view[360:840, 480:1120][None])
    # R2D2's reliability and repeatability thresholds (0.7) pass no pixel
    # of the random network (its reliability softmax sits near 0.5), so
    # they are 0 here, as the JAX package's own random-weight tests set them
    detectors = {"superpoint": {"max_keypoints": 4096},
                 "r2d2": {"max_keypoints": 4096,
                          "reliability_threshold": 0.0,
                          "repeatability_threshold": 0.0},
                 "d2net": {"max_keypoints": 4096}}
    for method, conf in detectors.items():
        model = get_model(method)({**conf, "pretrained": None},
                                  device="cuda")
        ms = _time_ms(lambda: model.detect(full), reps=3, warmup=1)
        n_kp = int(model.detect(full)["valid"].sum())
        out_d = model.detect(crop)
        out_c = get_model(method)({**conf, "pretrained": None},
                                  device="cpu").detect(crop)
        d2 = method == "d2net"
        agree = detector_agreement(np, out_d, out_c, stride=4 if d2 else 1,
                                   offset=1.5 if d2 else 0.0)
        pos_tol = D2NET_POS_TOL if d2 else 0.0
        far_max = D2NET_FAR_SHARE * agree["common"] if d2 else 0
        print(f"phase 21(a): {method} on a 1600x1200 view: {ms:.2f} ms per "
              f"image (CUDA events, outputs copied to the host), {n_kp} "
              f"keypoints of {conf['max_keypoints']}, descriptors "
              f"{out_d['descriptors'].shape[-1]}-d; cuda vs cpu on a 640x480 "
              f"crop: {agree} (limits: no untied difference, positions "
              f"{pos_tol} px, at most {far_max:.1f} cells beyond 1e-3 px, "
              f"scores 1e-5 relative, descriptors 1e-4)")
        if not (agree["untied"] == 0 and agree["common"] > 0
                and agree["pos"] <= pos_tol and agree["far"] <= far_max
                and agree["score_rel"] <= 1e-5 and agree["desc"] <= 1e-4):
            raise SystemExit(f"{method}: cuda and cpu detections disagree")
        del model
    del full
    torch.cuda.empty_cache()

    # (b) the triangulation harness under the profiler (device activity
    # only: its overhead is the tracing of each launch)
    stats = {}
    zero_counts()

    def run():
        return run_scene(scene, tmp / "refined",
                         conf=load_config("pixsfm_eth3d"),
                         tolerances=ETH3D_TOLERANCES, method="superpoint",
                         device="cuda", stats=stats)

    t0 = time.perf_counter()
    metrics, _, busy_p, kern_p, tab_p = profile_stage(torch, run, cpu=False)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    launches_tri = read_counts()
    stage = {k: round(v, 3) for k, v in stats.items() if k.endswith("_s")}
    print(f"phase 21(b): run_scene superpoint: {t_p:.2f} s; accuracy "
          f"{metrics['accuracy']}, completeness {metrics['completeness']} "
          f"at {list(ETH3D_TOLERANCES)}; {metrics['num_points']} points, "
          f"mean reprojection error {metrics['mean_reproj_error']:.4f} px; "
          f"{stats['keypoints_per_image']:.0f} keypoints per image, "
          f"{stats['num_pairs']} verified pairs; stages {stage}; launches "
          f"{launches_tri}")
    oka = {k: v[0] for k, v in stats["KA"].items()}
    oba = {k: v[0] for k, v in stats["BA"].items()}
    print(f"phase 21(b): KA {oka['iterations']} LM iterations on "
          f"{oka['num_problems']} problems, cost {oka['initial_cost']:.4f} "
          f"-> {oka['final_cost']:.4f}; BA {oba['iterations']} LM "
          f"iterations, cost {oba['initial_cost']:.4f} -> "
          f"{oba['final_cost']:.4f}")
    if launches_tri["K1"] <= 0 or launches_tri["K2"] <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the ETH3D path: "
                         f"{launches_tri}")
    if not (oka["final_cost"] < oka["initial_cost"]
            and oba["final_cost"] < oba["initial_cost"]):
        raise SystemExit("ETH3D harness: the KA or BA cost did not fall")
    if not (metrics["num_points"] >= ETH3D_MIN_POINTS
            and metrics["mean_reproj_error"] < 3.0):
        raise SystemExit(f"ETH3D harness: {metrics['num_points']} points "
                         f"(at least {ETH3D_MIN_POINTS}), mean reprojection "
                         f"error {metrics['mean_reproj_error']} (< 3 px)")
    # where its time goes: the run's profile
    in_situ = _in_situ(kern_p, {"K1": "interp_kernel", "K2": "pcg_kernel"},
                       launches_tri)
    print(f"phase 21(b) (the run's profile): {t_p:.3f} s wall, "
          f"{busy_p:.3f} s device busy (idle share {1 - busy_p / t_p:.2f}); "
          f"in-situ device ms per launch {in_situ}")
    for name, calls, dev_ms in kern_p[:8]:
        print(f"  ETH3D triangulation harness: {dev_ms:9.3f} ms in "
              f"{calls:6d} launches  {name[:90]}")

    # (c) the localization harness on the same scene. The preset extracts
    # each query's whole dense map (overwrite_features_sparse: false), and
    # QKA and QBA read it as one 1200-row patch: the K1 calls on such a map
    # are watched (every name bound to the wrapper is swapped for one that
    # reads the wrapper's own count around the call, and keeps the first
    # call's inputs), so that (c)'s launches split by shape and K1 is held
    # to its plain version on the inputs the path gave it
    stats_l = {}
    dense = {"launches": 0, "args": None}
    wrapper = interpolate_cuda.interpolate_rows
    patch = load_config("pixsfm_eth3d").dense_features.patch_size

    def watched(rows, H, W, C, row_base, r, c, l2):
        if H <= patch:
            return wrapper(rows, H, W, C, row_base, r, c, l2)
        if dense["args"] is None:
            dense["args"] = (rows, H, W, C, row_base.clone(), r.clone(),
                             c.clone(), l2)
        before = interpolate_cuda.launches
        out = wrapper(rows, H, W, C, row_base, r, c, l2)
        dense["launches"] += interpolate_cuda.launches - before
        return out

    def rebind(old, new):
        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").startswith("pixsfm_tpu_torch") \
                    and getattr(m, "interpolate_rows", None) is old:
                m.interpolate_rows = new

    zero_counts()
    t0 = time.perf_counter()
    rebind(wrapper, watched)
    try:
        res = run_scene_localization(scene, tmp / "loc",
                                     conf=load_config("pixsfm_eth3d"),
                                     num_holdout=3,
                                     thresholds=ETH3D_LOC_THRESHOLDS,
                                     method="superpoint", device="cuda",
                                     stats=stats_l)
        torch.cuda.synchronize()
    finally:
        rebind(watched, wrapper)
    wall_l = time.perf_counter() - t0
    launches_loc = read_counts()
    n_loc = sum(e is not None for e in res["errors_m"])
    stage = {k: round(v, 3) for k, v in stats_l.items() if k.endswith("_s")}
    print(f"phase 21(c): run_scene_localization superpoint, "
          f"{res['num_queries']} held-out queries: {wall_l:.2f} s; AUC "
          f"{[round(a, 2) for a in res['auc']]} at "
          f"{list(ETH3D_LOC_THRESHOLDS)}, median error "
          f"{res['median_error_m']:.4f}, errors {res['errors_m']}; "
          f"{n_loc} of {res['num_queries']} localized; stages {stage}; "
          f"launches {launches_loc}")
    if n_loc < 2:
        raise SystemExit("ETH3D localization: fewer than 2 of 3 queries "
                         "localized")
    if launches_loc["K1"] <= 0 or dense["launches"] <= 0:
        raise SystemExit(f"K1 did not launch on the query's dense map in "
                         f"the localization harness: {launches_loc}, "
                         f"{dense['launches']} on dense maps")
    print(f"phase 21(c): K1 launches on the queries' dense maps "
          f"{dense['launches']}, on 16x16 patches "
          f"{launches_loc['K1'] - dense['launches']}; K1 against its plain "
          f"version on the first dense-map launch's inputs:")
    k1_dense = check_k1_recorded(torch, interpolate_cuda, *dense["args"])
    del dense["args"]
    tmp21.cleanup()
    torch.cuda.empty_cache()

    # (d) VGGNet KA at full width on phase 5's scene: three levels of
    # 64 / 256 / 512 channels, bf16 patches of 16 px
    images, kps, _, matches, scores = make_scene(
        np, seed=0, n_views=10, n_points=2000, W=1600, H=1200, margin=150)
    kps2 = {k: v.copy() for k, v in kps.items()}
    sfm = PixSfM({"dense_features": {"model": {"name": "vggnet"}}},
                 device="cuda")
    widths = list(sfm.extractor.model.output_dims)
    zero_counts()
    t0 = time.perf_counter()
    _, out = sfm.run_ka(kps, images, matches=matches, scores=scores)
    torch.cuda.synchronize()
    wall_v = time.perf_counter() - t0
    launches_vgg = read_counts()
    by_width = dict(interpolate_cuda.launches_by_channels)
    print(f"phase 21(d): run_ka with VGGNet (levels of {widths} channels) "
          f"on phase 5's scene: {wall_v:.2f} s; per level LM iterations "
          f"{out['iterations']}, cost {out['initial_cost']} -> "
          f"{out['final_cost']}; K1 launches by channel count {by_width}; "
          f"launches {launches_vgg}")
    if sorted(widths) != [64, 256, 512] or any(
            by_width.get(c, 0) <= 0 for c in widths):
        raise SystemExit(f"VGGNet KA: K1 did not launch at every width: "
                         f"{by_width}")
    if not all(f < i for i, f in zip(out["initial_cost"],
                                     out["final_cost"])):
        raise SystemExit("VGGNet KA: a level's cost did not fall")
    # K1 in situ per width: the same KA again under the profiler (the
    # general variant serves 64 channels, the wide kernel 256 and 512)
    _, t_v, busy_v, kern_v, tab_v = profile_stage(
        torch, lambda: sfm.run_ka(kps2, images, matches=matches,
                                  scores=scores))
    in_situ_vgg = {}
    for C in widths:
        hits = [(c, ms) for n, c, ms in kern_v if "interp_kernel" in n
                and ("general" in n if C == 64 else f", {C}>" in n)]
        if not hits:
            raise SystemExit(f"VGGNet KA: the profile shows no K1 launch "
                             f"at C = {C}")
        in_situ_vgg[C] = sum(ms for _, ms in hits) / sum(c for c, _ in hits)
    print(f"phase 21(d) (under the profiler): {t_v:.3f} s wall, "
          f"{busy_v:.3f} s device busy (idle share {1 - busy_v / t_v:.2f}); "
          f"K1 in-situ device ms per launch by channel count {in_situ_vgg}")
    if profile_out:
        with open(Path(profile_out) / "chip_smoke_profile.txt", "a") as fh:
            fh.write(f"\n\n== ETH3D triangulation harness ==\n"
                     f"{tab_p}\n\n== VGGNet KA ==\n{tab_v}\n")
    del sfm, images
    torch.cuda.empty_cache()
    launches = {k: launches_tri[k] + launches_loc[k] for k in launches_tri}
    launches["K1"] -= dense["launches"]
    print(f"phase 21: {time.perf_counter() - t21:.1f} s")
    return (launches, dense["launches"], k1_dense, launches_vgg, by_width,
            in_situ, in_situ_vgg)


def loftr_agreement(np, a, b):
    """cuda against cpu ``LoFTR.match_pair`` results, the valid matches
    keyed by their coarse index pair (image 0's cell ``mk0 / 8``, image 1's
    ``rint(mk1 / 8)``: the fine offset stays within +-4 px). On the common
    matches the largest fine position difference and the largest
    confidence difference relative to the largest confidence; ``differ``
    counts the pairs found on one device only, ``allowed`` how many may."""
    def keyed(out):
        mk0, mk1, conf, valid = out
        return {(tuple(m0.astype(np.int64) // 8),
                 tuple(np.rint(m1 / 8).astype(np.int64))): (m1, c)
                for m0, m1, c in zip(mk0[valid], mk1[valid], conf[valid])}

    A, B = keyed(a), keyed(b)
    common = set(A) & set(B)
    top = max((c for _, c in B.values()), default=1.0)
    return dict(
        n_cuda=len(A), n_cpu=len(B), common=len(common),
        differ=len(set(A) ^ set(B)),
        allowed=max(1, int(LOFTR_PAIR_SHARE * len(set(A) | set(B)))),
        pos=max((float(np.abs(A[k][0] - B[k][0]).max()) for k in common),
                default=0.0),
        conf_rel=max((abs(float(A[k][1] - B[k][1])) / top for k in common),
                     default=0.0))


def detector_free_path(np, PixSfM, load_config, scene, gt, names, device,
                       stats):
    """Phase 22(c)'s stages in ``run_scene``'s order on the views
    ``names`` of ``scene``, LoFTR at threshold 0: the reconstruction, the
    KA and BA summaries; ``stats`` receives the stage times and counts."""
    from pixsfm_tpu_torch.features.detectors import match_loftr_dir
    from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
    from pixsfm_tpu_torch.sfm.triangulation import \
        triangulate_reconstruction
    from pixsfm_tpu_torch.sfm.two_view import verify_all_pairs
    image_dir = scene / "images"
    ref = gt.copy()
    for im in list(ref.images.values()):
        if im.name not in names:
            del ref.images[im.image_id]
    t0 = time.perf_counter()
    kps, matches, scores = match_loftr_dir(
        image_dir, names, max_edge=1024,
        matcher_conf={"match_threshold": 0.0}, device=device, stats=stats)
    t1 = time.perf_counter()
    matches, scores = verify_all_pairs(matches, kps, scores)
    stats["verification_s"] = time.perf_counter() - t1
    stats["num_pairs"] = len(matches)
    sfm = PixSfM(load_config("pixsfm_eth3d"), device=device)
    t1 = time.perf_counter()
    graph = build_matching_graph(matches, scores)
    keypoints, oka = sfm.run_ka(kps, image_dir, graph=graph)
    stats["ka_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec = triangulate_reconstruction(ref, graph, keypoints, device=device)
    stats["triangulation_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    oba = sfm.run_ba(rec, image_dir)
    stats["ba_s"] = time.perf_counter() - t1
    stats["total_s"] = time.perf_counter() - t0
    return rec, oka, oba


def loftr_phase(torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
                schur_cuda, scene, gt):
    """Phase 22: the detector-free ETH3D path on phase 21's ``scene``.
    Returns the launches of (c)."""
    import tempfile

    from pixsfm_tpu_torch.eval.eth3d.triangulation import run_scene
    from pixsfm_tpu_torch.features.detectors import load_gray
    from pixsfm_tpu_torch.features.models.loftr import LoFTR
    t22 = time.perf_counter()
    tmp22 = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp22.name)
    zero_counts, read_counts = kernel_counts(torch, interpolate_cuda,
                                             cg_cuda, schur_cuda)
    names = sorted(im.name for im in gt.images.values())

    # (a) one pair at full width, as match_loftr_dir decodes it (1600x1200
    # x 0.64: 1024x768, a multiple of 64, so no padding), then cuda
    # against cpu on a 256x320 crop of it
    (im0, _), (im1, _) = (load_gray(scene / "images" / n, 1024)
                          for n in names[:2])
    model = LoFTR({"pretrained": None}, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_02 = int(model.match_pair(im0, im1)[3].sum())
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ms = _time_ms(lambda: model.match_pair(im0, im1), reps=5, warmup=1)
    model.conf["match_threshold"] = 0.0
    out_0 = model.match_pair(im0, im1)
    print(f"phase 22(a): LoFTR on one {im0.shape[1]}x{im0.shape[0]} pair: "
          f"{ms:.2f} ms per pair (CUDA events, outputs copied to the host, "
          f"TF32 off), peak device memory {peak:.2f} GB above the "
          f"{base / 1e9:.2f} GB allocated before; valid matches "
          f"{n_02} at threshold 0.2, {int(out_0[3].sum())} of "
          f"{len(out_0[3])} at 0")
    crop = (slice(256, 512), slice(352, 672))
    c0, c1 = (np.ascontiguousarray(im[crop]) for im in (im0, im1))
    cpu = LoFTR({"pretrained": None, "match_threshold": 0.0}, device="cpu")
    tok_d = model.coarse_features(model._image(c0), model._image(c1))[0]
    tok_c = cpu.coarse_features(cpu._image(c0), cpu._image(c1))[0]
    tok_err = float((tok_d.cpu() - tok_c).abs().max() / tok_c.abs().max())
    agree = loftr_agreement(np, model.match_pair(c0, c1),
                            cpu.match_pair(c0, c1))
    print(f"phase 22(a): cuda vs cpu on a 256x320 crop at threshold 0: "
          f"coarse tokens {tok_err:.2e} of the largest (limit "
          f"{LOFTR_TOKEN_RTOL}); matches {agree} (limits: at most "
          f"'allowed' pairs differ, positions {LOFTR_POS_TOL} px, "
          f"confidences {LOFTR_CONF_TOL} of the largest)")
    if not (tok_err <= LOFTR_TOKEN_RTOL and agree["common"] > 0
            and agree["differ"] <= agree["allowed"]
            and agree["pos"] <= LOFTR_POS_TOL
            and agree["conf_rel"] <= LOFTR_CONF_TOL):
        raise SystemExit("LoFTR: cuda and cpu disagree")
    del model, cpu, tok_d
    torch.cuda.empty_cache()

    # (b) the triangulation harness at its defaults on every view
    stats_b = {}
    t0 = time.perf_counter()
    metrics = run_scene(scene, tmp / "loftr",
                        conf=load_config("pixsfm_eth3d"),
                        tolerances=ETH3D_TOLERANCES, method="loftr",
                        device="cuda", stats=stats_b)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    stage = {k: round(v, 3) for k, v in stats_b.items() if k.endswith("_s")}
    print(f"phase 22(b): run_scene loftr on {len(names)} views: "
          f"{wall_b:.2f} s; {stats_b['matched_pairs']} matched pairs of "
          f"{len(names) * (len(names) - 1) // 2}, {stats_b['num_pairs']} "
          f"verified; {metrics['num_points']} points, accuracy "
          f"{metrics['accuracy']}; stages {stage}")
    if not (tmp / "loftr" / "results.json").exists():
        raise SystemExit("run_scene loftr wrote no results.json")

    # (c) the detector-free path at threshold 0 on LOFTR_VIEWS views
    stats_c = {}
    zero_counts()
    rec, oka, oba = detector_free_path(np, PixSfM, load_config, scene, gt,
                                       names[:LOFTR_VIEWS], "cuda", stats_c)
    launches = read_counts()
    oka = {k: v[0] for k, v in oka.items()}
    oba = {k: v[0] for k, v in oba.items()}
    stage = {k: round(v, 3) for k, v in stats_c.items() if k.endswith("_s")}
    print(f"phase 22(c): the detector-free path at threshold 0 on "
          f"{LOFTR_VIEWS} views: {stats_c['matched_pairs']} matched pairs, "
          f"{stats_c['num_pairs']} verified, "
          f"{stats_c['keypoints_per_image']:.0f} keypoints per image; KA "
          f"{oka['iterations']} LM iterations on {oka['num_problems']} "
          f"problems, cost {oka['initial_cost']:.4f} -> "
          f"{oka['final_cost']:.4f}; {len(rec.points3D)} points (at least "
          f"{LOFTR_MIN_POINTS}), mean reprojection error "
          f"{rec.mean_reprojection_error():.4f} px; BA {oba['iterations']} "
          f"LM iterations, cost {oba['initial_cost']:.4f} -> "
          f"{oba['final_cost']:.4f}; stages {stage}; launches {launches}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the detector-free "
                         f"path: {launches}")
    if not oka["final_cost"] < oka["initial_cost"]:
        raise SystemExit("detector-free path: the KA cost did not fall")
    if not len(rec.points3D) >= LOFTR_MIN_POINTS:
        raise SystemExit(f"detector-free path: {len(rec.points3D)} points "
                         f"(at least {LOFTR_MIN_POINTS})")
    tmp22.cleanup()
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 23: every interpolation config and solver option
# ---------------------------------------------------------------------------

# 2x2 node windows at +-0.5 px: (a)'s KA and BA, (c)'s references and QBA
OPT_NODES4 = [[-0.5, -0.5], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]
# (b): the photometric preset with KA on; its patch-warp BA capped
OPT_PHOTO_BA_ITERATIONS = 8
# (c): patch-warp QBA steps per query on the card, and on both devices for
# the query held cuda against cpu (fewer there: the card machine's CPU is
# slower per step)
OPT_QBA_STEPS = 20
OPT_CPU_QBA_STEPS = 10
# (d): LM iterations of the small-scene BA held cuda against cpu, and the
# limit on its final cost: NCC divides float32 rounding by each node
# window's spread, and 2x2 windows at +-0.5 px on smooth rendered maps
# spread little, so the NCC cases' limit of ROADMAP.md section 3 (5e-4)
# holds it (1.25e-5 and 2.0e-4 apart in two runs on an NVIDIA H100 80GB
# HBM3 at 700 W, the points 8.1e-5 and 4.3e-5), where phase 8 holds a
# geometric cost at 1e-4
OPT_BA_ITERATIONS = 5
OPT_NCC_COST_RTOL = 5e-4


def node_rows_watch(interpolate_cuda):
    """Swap ``interpolate_cuda.interpolate_node_rows`` for a watcher that
    keeps the first call's K1 inputs (the node queries expanded as the
    wrapper launches them). Returns (first, restore)."""
    from pixsfm_tpu_torch.base.interpolation import node_queries
    orig = interpolate_cuda.interpolate_node_rows
    first = {}

    def watch(rows, H, W, C, row_base, r, c, nodes, l2):
        if not first:
            first["args"] = (rows, H, W, C, *node_queries(row_base, r, c,
                                                          nodes))
            first["l2"] = bool(l2)
        return orig(rows, H, W, C, row_base, r, c, nodes, l2)

    interpolate_cuda.interpolate_node_rows = watch

    def restore():
        interpolate_cuda.interpolate_node_rows = orig
    return first, restore


def _levels0(out):
    return {k: v[0] for k, v in out.items()}


def options_ka_cuda_vs_cpu(np, PixSfM):
    """23(d), KA: phase 4's small scene through ``run_ka`` on cuda and cpu
    with each KA option; the keypoints within phase 4's limit."""
    images, kps, _, matches, scores = make_scene(
        np, seed=3, n_views=3, n_points=40, W=320, H=240, margin=60)
    cases = {
        "BILINEAR": {"interpolation": {"mode": "BILINEAR"}},
        "NEARESTNEIGHBOR": {"interpolation": {"mode": "NEARESTNEIGHBOR"}},
        "BICUBICCHAIN": {"interpolation": {"mode": "BICUBICCHAIN"}},
        "cg_block_size 2": {"mapping": {"KA": {"optimizer": {"solver": {
            "cg_block_size": 2, "linear_solver": "cg"}}}}},
        "compaction_segment 5": {"mapping": {"KA": {
            "compaction_segment": 5}}},
    }
    lines, bad = [], []
    for label, conf in cases.items():
        outs = {}
        for d in ("cuda", "cpu"):
            kp, out = PixSfM(conf, device=d).run_ka(
                {k: v.copy() for k, v in kps.items()}, images,
                matches=matches, scores=scores)
            outs[d] = (kp, _levels0(out))
        diff = max(float(np.abs(outs["cuda"][0][n] - outs["cpu"][0][n])
                         .max()) for n in kps)
        o = outs["cuda"][1]
        lines.append(f"{label}: {o['iterations']} LM iterations, cost "
                     f"{o['initial_cost']:.4f} -> {o['final_cost']:.4f}, "
                     f"max |kp(cuda) - kp(cpu)| = {diff:.2e} px")
        if not (diff <= 0.05 and np.isfinite(o["final_cost"])
                and o["final_cost"] <= o["initial_cost"]):
            bad.append(label)
    print("phase 23(d): run_ka on phase 4's scene, cuda against cpu (limit "
          "0.05 px, the cost must not rise): " + "; ".join(lines))
    if bad:
        raise SystemExit(f"KA options: cuda and cpu disagree or the cost "
                         f"rose: {bad}")


def options_ba_cuda_vs_cpu(torch, np, PixSfM, load_config, tmp):
    """23(d), BA: feature-reference BA with 2x2 NCC node windows (no
    closed-form Jacobian: forward mode over the residual) on phase 12's
    scene with the deterministic ``image`` maps, poses free, through
    ``refine_reconstruction`` on cuda and cpu: the points within phase
    8's 1e-3, the final cost within ``OPT_NCC_COST_RTOL``."""
    from pixsfm_tpu_torch.ops import schur as schur_mod
    rec, views, _ = make_ba_scene(torch, np, seed=13, n_views=12,
                                  n_points=1500, W=640, H=480,
                                  device="cuda", min_track=3, max_track=3)
    conf = load_config("photometric", extra={"mapping": {"BA": {
        "strategy": "feature_reference",
        "interpolation": {"mode": "BICUBIC", "l2_normalize": False,
                          "ncc_normalize": True, "nodes": OPT_NODES4},
        "optimizer": {"refine_extrinsics": True, "solver": {
            "max_num_iterations": OPT_BA_ITERATIONS}}}}})
    src = Path(tmp) / "options_ba_in"
    rec.write(src)
    pids = sorted(rec.points3D)
    seen = []
    orig = schur_mod.jacfwd_residual_jac
    schur_mod.jacfwd_residual_jac = lambda *a: seen.append(a) or orig(*a)
    runs = {}
    try:
        for d in ("cuda", "cpu"):
            if d == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_rec, out = PixSfM(conf, device=d).refine_reconstruction(
                Path(tmp) / f"options_ba_{d}", src, views)
            if d == "cuda":
                torch.cuda.synchronize()
            runs[d] = (_levels0(out), np.stack(
                [out_rec.points3D[p].xyz for p in pids]),
                time.perf_counter() - t0)
    finally:
        schur_mod.jacfwd_residual_jac = orig
    (o_d, x_d, w_d), (o_c, x_c, w_c) = runs["cuda"], runs["cpu"]
    dx = float(np.abs(x_d - x_c).max())
    print(f"phase 23(d): feature_reference BA, 2x2 NCC nodes on image maps "
          f"(forward-mode Jacobian, {len(seen)} solves took it), "
          f"{len(views)} views, {len(pids)} points: regime "
          f"{o_d['linear_solver']} / {o_c['linear_solver']}, "
          f"{o_d['iterations']} / {o_c['iterations']} LM iterations, cost "
          f"cuda {o_d['initial_cost']:.6f} -> {o_d['final_cost']:.6f} / cpu "
          f"{o_c['final_cost']:.6f}, max |xyz(cuda) - xyz(cpu)| = {dx:.2e} "
          f"(limits: cost rtol {OPT_NCC_COST_RTOL:g}, xyz 1e-3); {w_d:.2f} s "
          f"on cuda (BA "
          f"solve {o_d['time']:.3f} s), {w_c:.2f} s on cpu (BA solve "
          f"{o_c['time']:.3f} s)")
    if len(seen) < 2:
        raise SystemExit("NCC feature_reference BA did not take the "
                         "forward-mode Jacobian")
    if not (abs(o_d["final_cost"] - o_c["final_cost"])
            <= OPT_NCC_COST_RTOL * abs(o_c["final_cost"]) and dx <= 1e-3
            and o_d["final_cost"] < o_d["initial_cost"]):
        raise SystemExit("NCC feature_reference BA: cuda and cpu disagree "
                         "or the cost did not fall")


def options_phase(torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
                  schur_cuda, tri, loc_scene):
    """Phase 23 (see the module docstring). Returns the launches of (a),
    (b) and (c), and K1's figures on (a)'s first node-rows launch."""
    import tempfile
    from pixsfm_tpu_torch.localization import QueryLocalizer
    from pixsfm_tpu_torch.bundle_adjustment.references import Reference
    from pixsfm_tpu_torch.localize import (build_query_correspondences,
                                           localize_queries)
    (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
     err_tri, n_tri_pts) = tri
    zero, read = kernel_counts(torch, interpolate_cuda, cg_cuda, schur_cuda)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    sync = torch.cuda.synchronize

    # (a) node windows in KA and feature-reference BA at full width
    # (a dict over PixSfM's defaults: PixSfM(load_config("default")) recurses
    # in both packages, ROADMAP.md section 3)
    conf_a = {"interpolation": {"nodes": OPT_NODES4},
              "mapping": {"BA": {"optimizer": {"solver": {
                  "max_num_iterations": BA_ITERATIONS}}}}}
    sfm = PixSfM(conf_a, device="cuda")
    first, restore = node_rows_watch(interpolate_cuda)
    zero()
    t0 = time.perf_counter()
    try:
        rec_a, out_a = sfm._triangulation(
            tmp / "nodes", reference, views_t,
            {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
        sync()
    finally:
        restore()
    wall_a = time.perf_counter() - t0
    launches_a = read()
    oka, oba = _levels0(out_a["KA"]), _levels0(out_a["BA"])
    err_a = triangulated_error(np, rec_a, truth_t)
    print(f"phase 23(a): PixSfM(default + 2x2 nodes at +-0.5 px, L2 on)."
          f"_triangulation on phase 11's scene {wall_a:.2f} s (KA "
          f"{oka['time']:.2f} s, {oka['num_problems']} problems, "
          f"{oka['iterations']} LM iterations, cost "
          f"{oka['initial_cost']:.4f} -> {oka['final_cost']:.4f}; "
          f"triangulation {out_a['triangulation']['time']:.2f} s, "
          f"{len(rec_a.points3D)} points; BA references "
          f"{oba['references_time']:.2f} s, solve {oba['time']:.2f} s, "
          f"{oba['linear_solver']} step, {oba['iterations']} LM / "
          f"{oba['cg_iterations']} CG iterations, cost "
          f"{oba['initial_cost']:.4f} -> {oba['final_cost']:.4f}); point "
          f"error to truth {err_raw:.5f} (unrefined) -> {err_a:.5f} (one "
          f"node, phase 11: {err_tri:.5f}); launches {launches_a}")
    if not all(np.isfinite(p.xyz).all() for p in rec_a.points3D.values()):
        raise SystemExit("non-finite points on the node-window path")
    if not (oka["final_cost"] < oka["initial_cost"]
            and oba["final_cost"] < oba["initial_cost"]):
        raise SystemExit("node windows: the KA or BA cost did not fall")
    if launches_a["K1"] <= 0 or launches_a["K2"] <= 0 or not first:
        raise SystemExit(f"node windows: K1 or K2 did not launch "
                         f"({launches_a})")
    del rec_a, sfm
    rows, H, W, C, rb, r, c = first["args"]
    print(f"phase 23(a): K1 on the path's first node-rows launch "
          f"({r.shape[0]} queries = {r.shape[0] // 4} keypoints x 4 nodes, "
          f"{rows.shape[0] // H} patches of {H}x{W}x{C})")
    k1 = check_k1_recorded(torch, interpolate_cuda, rows, H, W, C, rb, r, c,
                           first["l2"])
    del first, rows, rb, r, c
    torch.cuda.empty_cache()

    # (b) the photometric preset with KA: 16 NCC nodes on dense RGB maps
    conf_b = load_config("photometric", extra={"mapping": {
        "KA": {"apply": True},
        "BA": {"optimizer": {"solver": {
            "max_num_iterations": OPT_PHOTO_BA_ITERATIONS}}}}})
    sfm = PixSfM(conf_b, device="cuda")
    ka_interp = sfm.keypoint_adjuster.conf.interpolation
    zero()
    t0 = time.perf_counter()
    rec_b, out_b = sfm._triangulation(
        tmp / "photometric_ka", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    sync()
    wall_b = time.perf_counter() - t0
    launches_b = read()
    okb, obb = _levels0(out_b["KA"]), _levels0(out_b["BA"])
    err_b = triangulated_error(np, rec_b, truth_t)
    print(f"phase 23(b): PixSfM(photometric, KA on)._triangulation on phase "
          f"11's scene {wall_b:.2f} s (KA with {len(ka_interp.nodes)} nodes, "
          f"NCC {ka_interp.ncc_normalize}, L2 {ka_interp.l2_normalize} on "
          f"the dense RGB maps: {okb['time']:.2f} s, "
          f"{okb['num_problems']} problems, {okb['iterations']} LM "
          f"iterations, cost {okb['initial_cost']:.4f} -> "
          f"{okb['final_cost']:.4f}; {len(rec_b.points3D)} points; "
          f"patch_warp BA solve {obb['time']:.2f} s, {obb['iterations']} LM "
          f"/ {obb['cg_iterations']} CG iterations, cost "
          f"{obb['initial_cost']:.6f} -> {obb['final_cost']:.6f}); point "
          f"error to truth {err_raw:.5f} (unrefined) -> {err_b:.5f}; "
          f"launches {launches_b}")
    if not (len(ka_interp.nodes) == 16 and ka_interp.ncc_normalize
            and not ka_interp.l2_normalize):
        raise SystemExit("photometric KA did not take the preset's nodes")
    if not (okb["final_cost"] < okb["initial_cost"]
            and obb["final_cost"] < obb["initial_cost"]):
        raise SystemExit("photometric with KA: a cost did not fall")
    if launches_b["K1"] <= 0 or launches_b["K2"] <= 0:
        raise SystemExit(f"photometric with KA: K1 or K2 did not launch "
                         f"({launches_b})")
    if not all(np.isfinite(p.xyz).all() for p in rec_b.points3D.values()):
        raise SystemExit("non-finite points on the photometric KA path")
    del rec_b, sfm
    torch.cuda.empty_cache()

    # (c) localization with "full" references: patch-warp QBA
    (views, ref_views, rec, queries, keypoints, pairs, matches, gt,
     extent) = loc_scene

    def loc_conf(steps):
        return load_config("default", extra={
            "interpolation": {"nodes": OPT_NODES4},
            "localization": {
                "target_reference": "full",
                "references": {"compute_offsets3D": True},
                "QKA": {"apply": False},
                "QBA": {"optimizer": {"solver": {
                    "max_num_iterations": steps}}}}})

    zero()
    t0 = time.perf_counter()
    loc = QueryLocalizer(rec, loc_conf(OPT_QBA_STEPS), image_dir=ref_views,
                         device="cuda")
    sync()
    t_refs = time.perf_counter() - t0
    some = next(iter(loc.references[0].values()))
    from pixsfm_tpu_torch.localization import main as loc_main
    from pixsfm_tpu_torch.localization import pnp as pnp_mod
    times, _, restore_t = _stage_timers(sync, loc, loc_main)
    calls, restore_p = _pnp_hook(np, (loc_main, pnp_mod))
    t0 = time.perf_counter()
    try:
        serial = localize_queries(loc, queries, keypoints, pairs, matches,
                                  image_dir=views)
        sync()
    finally:
        restore_p()
        restore_t()
    wall_c = time.perf_counter() - t0
    launches_c = read()
    n_ok = sum(bool(res.get("success")) for res in serial.values())
    # per query: its PnP pose (one PnP call each, QKA being off), whether
    # that pose kept the f64 polish, and the errors to the truth before
    # and after patch-warp QBA
    rows_c, bad = [], []
    polished = ([c["polished"] for c in calls] if len(calls) == len(queries)
                else [True] * len(queries))
    for (qname, _), pnp, pol in zip(queries, calls, polished):
        res = serial[qname]
        if not res.get("success"):
            rows_c.append(f"{qname} failed")
            continue
        e0 = pose_error(np, pnp["qvec"], pnp["tvec"], gt[qname])
        e1 = pose_error(np, res["qvec"], res["tvec"], gt[qname])
        rows_c.append(f"{qname} {e0[0]:.3f} -> {e1[0]:.3f} deg, "
                      f"{e0[1] / extent:.2e} -> {e1[1] / extent:.2e} "
                      f"({'polished' if pol else 'unpolished'} PnP pose, "
                      f"QBA cost {res['QBA']['initial_cost']:.3f} -> "
                      f"{res['QBA']['final_cost']:.3f})")
        if (pol and not (e1[0] < 0.5 and e1[1] / extent < 1e-2)) \
                or e1[0] > e0[0] + 0.05 \
                or not res["QBA"]["final_cost"] <= res["QBA"]["initial_cost"]:
            bad.append(qname)
    print(f"phase 23(c): localization with target_reference full "
          f"(compute_offsets3D, 2x2 nodes, QKA off, patch-warp QBA of "
          f"{OPT_QBA_STEPS} steps): references {t_refs:.2f} s (node "
          f"offsets {tuple(some.node_offsets3D.shape)}, descriptors "
          f"{some.descriptor.shape[0]}), localize_queries {wall_c:.2f} s for "
          f"{len(queries)} queries ({len(queries) / wall_c:.3f} queries/s; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in times.items()
                      if k in ("query extraction", "PnP", "QBA"))
          + f"); {n_ok} of {len(queries)} localized; errors to the truth "
          f"after PnP -> after QBA: " + "; ".join(rows_c)
          + f" (phase 18's limits 0.5 deg, 1e-2 of the extent, held where "
          f"the PnP pose kept its polish; QBA may not raise the cost nor "
          f"add 0.05 deg); launches {launches_c}")
    if not isinstance(some, Reference) or some.node_offsets3D is None:
        raise SystemExit("full mode: the references carry no node offsets")
    if n_ok < len(queries) - 1:
        raise SystemExit(f"full mode: only {n_ok} of {len(queries)} "
                         f"queries localized")
    if bad:
        raise SystemExit(f"full mode: {bad} off the truth or made worse "
                         f"by QBA")

    # one query on cuda and on cpu: the whole flow (QBA capped) within
    # phase 14's polished limit, patch-warp QBA from identical inputs
    # within phase 18's 1e-4
    from pixsfm_tpu_torch.features.featuremaps import FeatureMap
    locs = {d: QueryLocalizer(rec, loc_conf(OPT_CPU_QBA_STEPS),
                              references=loc.references, device=d)
            for d in ("cuda", "cpu")}
    qname, cam = queries[0]
    p2D, p3D = build_query_correspondences(rec, qname, pairs, matches)
    X = np.asarray([rec.points3D[p].xyz for p in p3D])
    fm = loc.extract_query_fmaps(keypoints[qname], p2D, views[qname])
    maps = {"cuda": fm, "cpu": [FeatureMap(f.patches.cpu(), f.keypoint_ids(),
                                           f.corners, f.scale) for f in fm]}
    refs = locs["cuda"].get_query_references(p3D)[0]
    out, qba, walls = {}, {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[d] = locs[d].localize(keypoints[qname], p2D, p3D, cam,
                                  query_fmaps=maps[d])
        walls[d] = time.perf_counter() - t0
    start = serial[qname]
    for d in ("cuda", "cpu"):
        qba[d] = locs[d].qba.refine(start["qvec"], start["tvec"], cam, X,
                                    maps[d][0], refs,
                                    inliers=start["inliers"],
                                    point2D_idxs=p2D)
    same = bool(out["cuda"].get("success")) == bool(out["cpu"].get(
        "success"))
    fin_r, fin_t = pose_agreement(np, out["cuda"], out["cpu"], X)
    q_r, q_t = pose_agreement(np, qba["cuda"], qba["cpu"], X)
    print(f"phase 23(c): {qname} on cuda / cpu (QBA {OPT_CPU_QBA_STEPS} "
          f"steps) {walls['cuda']:.2f} / {walls['cpu']:.2f} s: successes "
          f"equal {same}, inliers {out['cuda'].get('num_inliers')} / "
          f"{out['cpu'].get('num_inliers')}, final poses within "
          f"{fin_r:.2e} rad, {fin_t:.2e} relative (limits "
          f"{PNP_POLISHED_TOL:g}); patch-warp QBA from identical inputs "
          f"(costs {qba['cuda']['initial_cost']:.4f} -> "
          f"{qba['cuda']['final_cost']:.4f} / "
          f"{qba['cpu']['final_cost']:.4f}) within {q_r:.2e} rad, "
          f"{q_t:.2e} relative (limits 1e-4)")
    if not (same and max(fin_r, fin_t) <= PNP_POLISHED_TOL
            and max(q_r, q_t) <= 1e-4):
        raise SystemExit("full mode: cuda and cpu disagree")
    del loc, locs, fm, maps
    torch.cuda.empty_cache()

    # (d) cuda against cpu on small scenes, one run per option
    options_ka_cuda_vs_cpu(np, PixSfM)
    options_ba_cuda_vs_cpu(torch, np, PixSfM, load_config, tmp)

    # ... and at phase 5's full width: KA with compaction and with
    # block-Jacobi CG beside the default solve, in one call
    images5, kps5, _, matches5, scores5 = make_scene(
        np, seed=0, n_views=10, n_points=2000, W=1600, H=1200, margin=150)
    lines = []
    for label, extra in (
            ("default", {}),
            ("compaction_segment 5", {"mapping": {"KA": {
                "compaction_segment": 5}}}),
            ("cg_block_size 2", {"mapping": {"KA": {"optimizer": {
                "solver": {"cg_block_size": 2}}}}})):
        sfm = PixSfM(extra, device="cuda")
        sync()
        t0 = time.perf_counter()
        _, o = sfm.run_ka({k: v.copy() for k, v in kps5.items()}, images5,
                          matches=matches5, scores=scores5)
        sync()
        o = _levels0(o)
        lines.append(f"{label}: run_ka {time.perf_counter() - t0:.2f} s, "
                     f"KA {o['time']:.3f} s, {o['iterations']} LM "
                     f"iterations, cost {o['initial_cost']:.4f} -> "
                     f"{o['final_cost']:.4f}")
        if not o["final_cost"] < o["initial_cost"]:
            raise SystemExit(f"KA {label} at full width: the cost did not "
                             f"fall")
    print("phase 23(d): run_ka on phase 5's scene at full width: "
          + "; ".join(lines))
    tmp_dir.cleanup()
    return launches_a, launches_b, launches_c, k1


# ---------------------------------------------------------------------------
# phase 24: sharding over a device mesh
# ---------------------------------------------------------------------------

# (c): costmap BA on phase 11's scene at the low_memory preset's 8 px,
# capped at this many LM iterations, inner iterations off (the strict
# limits of phase 19(b): the same cost patches, cost rtol 1e-4, points
# 1e-3). The preset's LM rejects its first candidates until lambda has
# grown (6 rejections before the first accepted step on a CPU dry run of
# this phase at 640x480), so 5 iterations could compare rejected
# candidates only: 8 take some accepted steps
SHARD_COSTMAP_ITERATIONS = 8


def window_read_watch(bmain):
    """Swap ``bundle_adjustment.main._Windows.read`` for a watcher that
    keeps the K1 inputs of the first window-layout read (each observation's
    own window, one row block each). Returns (first, restore)."""
    import torch
    orig = bmain._Windows.read
    first = {}

    def watch(self, row, pix, interp):
        if not first:
            pc, _ = self.coords(row, pix)
            first["args"] = (self.rows, self.H, self.W, self.C,
                             (row * self.H).to(torch.int32),
                             pc[:, 1].contiguous(), pc[:, 0].contiguous())
            first["l2"] = bool(interp.l2_normalize)
        return orig(self, row, pix, interp)

    bmain._Windows.read = watch

    def restore():
        bmain._Windows.read = orig
    return first, restore


def sharded_phase(torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
                  schur_cuda, ka_scene, tri, loc_scene):
    """Phase 24 (see the module docstring). Returns the launches of the
    sharded runs (in all and by run) and K1's figures on the first
    window-layout launch."""
    import tempfile
    from pixsfm_tpu_torch.bundle_adjustment import CostMapBundleAdjuster
    from pixsfm_tpu_torch.bundle_adjustment import main as bmain
    from pixsfm_tpu_torch.bundle_adjustment.costmaps import (
        costmap_solve, extract_costmaps)
    from pixsfm_tpu_torch.base.interpolation import InterpolationConfig
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    from pixsfm_tpu_torch.keypoint_adjustment import main as kmain
    from pixsfm_tpu_torch.localization import QueryLocalizer
    from pixsfm_tpu_torch.localize import build_query_correspondences
    from pixsfm_tpu_torch.parallel import Mesh
    t_phase = time.perf_counter()
    mesh = Mesh(["cuda:0", "cuda:0"])
    zero, read = kernel_counts(torch, interpolate_cuda, cg_cuda, schur_cuda)
    sync = torch.cuda.synchronize
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    by_run = {}

    def sharded(sfm):
        sfm.keypoint_adjuster._parallel_mesh = lambda: mesh
        sfm.bundle_adjuster._parallel_mesh = lambda: mesh
        return sfm

    # (a) solve_ka_problems at phase 5's KA shape: the problems of run_ka,
    # solved again with the problem axis over the two shards
    images, kps, matches, scores = ka_scene
    seen = {}
    orig = kmain.solve_ka_problems

    def record(*a, **kw):
        seen["call"] = (a, kw)
        seen["out"] = orig(*a, **kw)
        return seen["out"]

    kmain.solve_ka_problems = record
    try:
        PixSfM(device="cuda").run_ka({k: v.copy() for k, v in kps.items()},
                                     images, matches=matches, scores=scores)
    finally:
        kmain.solve_ka_problems = orig
    a, kw = seen["call"]
    problems = a[0]
    zero()
    t0 = time.perf_counter()
    kp_sh, sum_sh = orig(*a, **dict(kw, mesh=mesh))
    sync()
    wall_a = time.perf_counter() - t0
    by_run["KA (24a)"] = read()
    kp_one, sum_one = seen["out"]
    valid = problems.kp_valid
    dkp = float(np.abs(kp_sh[valid] - kp_one[valid]).max())
    dcost = abs(sum_sh["final_cost"] - sum_one["final_cost"]) \
        / abs(sum_one["final_cost"])
    print(f"phase 24(a): solve_ka_problems on phase 5's {problems.kp0.shape[0]}"
          f" problems of {problems.kp0.shape[1]} keypoints over "
          f"{mesh}: {wall_a:.2f} s, {sum_sh['iterations']} LM iterations, "
          f"cost {sum_sh['initial_cost']:.4f} -> {sum_sh['final_cost']:.4f} "
          f"(unsharded {sum_one['final_cost']:.4f}); max |kp(sharded) - "
          f"kp(unsharded)| = {dkp:.2e} px, cost {dcost:.2e} relative "
          f"(limits 5e-4 px, rtol 1e-4); launches {by_run['KA (24a)']}")
    if not (dkp <= 5e-4 and dcost <= 1e-4
            and min(by_run["KA (24a)"]["K1"], by_run["KA (24a)"]["K2"]) > 0):
        raise SystemExit("sharded KA disagrees with the unsharded solve or "
                         "launched no kernel")
    del seen, problems

    # (b) the triangulation body with the mesh in KA, the references and
    # feature_reference BA (window layout), against the same call unsharded
    (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
     err_tri, n_tri_pts) = tri
    conf_b = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_ITERATIONS}}}}}
    runs = {}
    first, restore = window_read_watch(bmain)
    for label in ("unsharded", "sharded"):
        sfm = PixSfM(conf_b, device="cuda")
        if label == "sharded":
            sharded(sfm)
            zero()
        else:
            sync()
        t0 = time.perf_counter()
        try:
            # a copy of the reference each: BA refines the intrinsics of
            # the cameras the triangulated model shares with it
            rec, out = sfm._triangulation(
                tmp / label, reference.copy(), views_t,
                {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
            sync()
        finally:
            if label == "sharded":
                restore()
        runs[label] = (rec, _levels0(out["KA"]), _levels0(out["BA"]),
                       time.perf_counter() - t0)
        if label == "sharded":
            by_run["triangulation (24b)"] = read()
        elif first:
            raise SystemExit("the unsharded BA read windows")
        del sfm
    (rec_a, ka_a, ba_a, w_a), (rec_b, ka_b, ba_b, w_b) = (
        runs["unsharded"], runs["sharded"])
    common = sorted(set(rec_a.points3D) & set(rec_b.points3D))
    dx = max(float(np.abs(rec_a.points3D[p].xyz - rec_b.points3D[p].xyz)
                   .max()) for p in common)
    dcost = abs(ba_b["final_cost"] - ba_a["final_cost"]) \
        / abs(ba_a["final_cost"])
    lb = by_run["triangulation (24b)"]
    print(f"phase 24(b): PixSfM._triangulation on phase 11's scene, KA, "
          f"references and feature_reference BA (window layout) over the "
          f"mesh: {w_b:.2f} s (KA {ka_b['time']:.2f} s, references "
          f"{ba_b['references_time']:.2f} s, BA solve {ba_b['time']:.2f} s, "
          f"{ba_b['linear_solver']} step, grid T {ba_b['obs_grid_T']}, "
          f"{ba_b['iterations']} LM / {ba_b['cg_iterations']} CG "
          f"iterations, cost {ba_b['initial_cost']:.4f} -> "
          f"{ba_b['final_cost']:.4f}); unsharded {w_a:.2f} s (BA solve "
          f"{ba_a['time']:.2f} s, cost {ba_a['final_cost']:.4f}); points "
          f"{len(rec_b.points3D)} / {len(rec_a.points3D)}, max |xyz(sharded)"
          f" - xyz(unsharded)| = {dx:.2e}, BA cost {dcost:.2e} relative "
          f"(limits 5e-3, rtol 1e-3); point error to truth "
          f"{triangulated_error(np, rec_b, truth_t):.5f} (phase 11: "
          f"{err_tri:.5f}); launches {lb}")
    if not (len(common) == len(rec_a.points3D) == len(rec_b.points3D)
            and dx <= 5e-3 and dcost <= 1e-3):
        raise SystemExit("the sharded triangulation path disagrees with "
                         "the unsharded one")
    if not (ba_b["linear_solver"] == "cg" and ba_b["obs_grid_T"] == 0
            and ba_b["final_cost"] < ba_b["initial_cost"]):
        raise SystemExit("sharded BA: not the flat regime, or the cost did "
                         "not fall")
    if min(lb["K1"], lb["K2"]) <= 0 or lb["K3a"] or lb["K3b"] or lb["K3c"] \
            or not first:
        raise SystemExit(f"sharded triangulation path: K1 or K2 did not "
                         f"launch, or K3 did ({lb})")
    rows, H, W, C, rb, r, c = first["args"]
    print(f"phase 24(b): K1 on the first window-layout launch ({r.shape[0]}"
          f" observations, each its own {H}x{W}x{C} window)")
    k1 = check_k1_recorded(torch, interpolate_cuda, rows, H, W, C, rb, r, c,
                           first["l2"])
    del first, rows, rb, r, c, rec_b
    torch.cuda.empty_cache()

    # (c) costmap_window BA at 8 px on (b)'s model, from one set of cost
    # patches, against the unsharded costmap BA
    conf_c = load_config("low_memory", extra={"mapping": {"BA": {
        "optimizer": {"solver": {
            "max_num_iterations": SHARD_COSTMAP_ITERATIONS,
            "use_inner_iterations": False}}}}})
    sfm = PixSfM(conf_c, device="cuda")
    t0 = time.perf_counter()
    fset = features_from_reconstruction(sfm.extractor, rec_a,
                                        views_t).fset(0)
    ba_conf = sfm.bundle_adjuster.conf
    cset = extract_costmaps(rec_a, fset, ba_conf.costmaps,
                            ba_conf.references,
                            InterpolationConfig.from_conf(
                                ba_conf.interpolation))[0]
    sync()
    t_cm = time.perf_counter() - t0
    del fset

    class Sharded(CostMapBundleAdjuster):
        def _parallel_mesh(self):
            return mesh

    solves = {}
    for label, cls in (("unsharded", CostMapBundleAdjuster),
                       ("sharded", Sharded)):
        rec_c = rec_a.copy()
        if label == "sharded":
            zero()
        t0 = time.perf_counter()
        o = costmap_solve(cls(ba_conf, device="cuda"), rec_c, cset)
        sync()
        solves[label] = (o, np.stack([rec_c.points3D[p].xyz
                                      for p in common]),
                         time.perf_counter() - t0)
        if label == "sharded":
            by_run["costmap BA (24c)"] = read()
    (o_a, x_a, t_a), (o_b, x_b, t_b) = solves["unsharded"], solves["sharded"]
    dx = float(np.abs(x_a - x_b).max())
    dcost = abs(o_b["final_cost"] - o_a["final_cost"]) / abs(o_a["final_cost"])
    print(f"phase 24(c): costmap_window BA (8 px, points only, "
          f"{SHARD_COSTMAP_ITERATIONS} LM iterations, inner iterations off) "
          f"on (b)'s model from one set of cost patches (extracted in "
          f"{t_cm:.2f} s): sharded {t_b:.2f} s ({o_b['linear_solver']} step, "
          f"{o_b['iterations']} LM / {o_b['cg_iterations']} CG iterations, "
          f"cost {o_b['initial_cost']:.6f} -> {o_b['final_cost']:.6f}), "
          f"unsharded {t_a:.2f} s (cost {o_a['final_cost']:.6f}); "
          f"{dcost:.2e} relative, points within {dx:.2e} (phase 19(b)'s "
          f"limits without inner iterations: rtol 1e-4, 1e-3); launches "
          f"{by_run['costmap BA (24c)']}")
    if not (dcost <= 1e-4 and dx <= 1e-3
            and o_b["final_cost"] < o_b["initial_cost"]):
        raise SystemExit("sharded costmap BA disagrees with the unsharded "
                         "one, or its cost did not fall")
    del cset, sfm, rec_a, solves
    torch.cuda.empty_cache()

    # (d) localize_batch on phase 18's queries with the localizer's mesh
    (views, ref_views, rec, queries, keypoints, pairs, matches_l, gt,
     extent) = loc_scene
    conf_d = load_config("default")
    loc = QueryLocalizer(rec, conf_d, image_dir=ref_views, device="cuda")

    class ShardedLocalizer(QueryLocalizer):
        def _parallel_mesh(self):
            return mesh

    loc_sh = ShardedLocalizer(rec, conf_d, references=loc.references,
                              device="cuda")
    batch_in = []
    for qname, cam in queries:
        p2D, p3D = build_query_correspondences(rec, qname, pairs, matches_l)
        batch_in.append(dict(keypoints=keypoints[qname], pnp_point2D_idxs=p2D,
                             pnp_points3D_id=p3D, query_camera=cam,
                             image_path=views[qname]))
    outs, walls = {}, {}
    for label, lz in (("unsharded", loc), ("sharded", loc_sh)):
        if label == "sharded":
            zero()
        else:
            sync()
        t0 = time.perf_counter()
        outs[label] = lz.localize_batch([dict(b) for b in batch_in])
        sync()
        walls[label] = time.perf_counter() - t0
        if label == "sharded":
            by_run["localize_batch (24d)"] = read()
    agree = compare_localizations(
        np, outs["unsharded"], outs["sharded"],
        [[rec.points3D[p].xyz for p in b["pnp_points3D_id"]]
         for b in batch_in], extent, LOC_BATCH_LIMITS)
    n_ok = sum(bool(o.get("success")) for o in outs["sharded"])
    print(f"phase 24(d): localize_batch of {len(queries)} queries over the "
          f"mesh {walls['sharded']:.2f} s, unsharded "
          f"{walls['unsharded']:.2f} s; {n_ok} localized; sharded against "
          f"unsharded: {agree['text']}; the JAX package's batch-test limits "
          f"met by {agree['tight']} of {agree['n']}; launches "
          f"{by_run['localize_batch (24d)']}")
    if not agree["ok"] or by_run["localize_batch (24d)"]["K1"] <= 0:
        raise SystemExit("sharded localize_batch disagrees with the "
                         "unsharded batch, or K1 did not launch")
    del loc, loc_sh
    tmp_dir.cleanup()
    torch.cuda.empty_cache()
    launches = {k: sum(n[k] for n in by_run.values())
                for k in ("K1", "K2", "K3a", "K3b", "K3c")}
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s; launches on "
          f"the sharded runs {launches}")
    return launches, by_run, k1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-out", default=None,
                        help="directory for the profiler tables")
    args = parser.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from pixsfm_tpu_torch import kernels
    from pixsfm_tpu_torch.ops import cg_cuda, interpolate_cuda, schur_cuda
    from pixsfm_tpu_torch.refine_hloc import PixSfM

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"phase 1: built {built} in {time.perf_counter() - t0:.1f} s")

    # -- phases 2-3: kernels against their plain versions ----------------------
    P, K = 128, 56                 # main path: chunk 128, 50 kps padded to 56
    k1 = check_k1(torch, interpolate_cuda, n_patches=20000,
                  n_queries=P * K, dtypes=(torch.float32, torch.bfloat16))
    k1["edge_max_abs_err"] = check_k1_edges(torch, interpolate_cuda)
    # the widths of VGGNet's levels (phase 21(d)) at the KA shape: 64 takes
    # the general variant, 256 and 512 the vector one
    k1_wide = {C: check_k1(torch, interpolate_cuda, n_patches=20000,
                           n_queries=P * K,
                           dtypes=(torch.float32, torch.bfloat16), C=C,
                           variant="general" if C == 64 else "vector")
               for C in (64, 256, 512)}
    torch.cuda.empty_cache()
    k2 = check_k2(torch, cg_cuda, P=P, N=2 * K, iters=15)

    # -- phase 4: small scene, cuda against cpu --------------------------------
    images, kps, truth, matches, scores = make_scene(
        np, seed=3, n_views=3, n_points=40, W=320, H=240, margin=60)
    kp_dev, _ = PixSfM(device="cuda").run_ka(
        {k: v.copy() for k, v in kps.items()}, images, matches=matches,
        scores=scores)
    kp_cpu, _ = PixSfM(device="cpu").run_ka(
        {k: v.copy() for k, v in kps.items()}, images, matches=matches,
        scores=scores)
    diff = max(float(np.abs(kp_dev[n] - kp_cpu[n]).max()) for n in kps)
    print(f"phase 4: small scene, max |kp(cuda) - kp(cpu)| = {diff:.2e} px "
          f"(limit 0.05 px)")
    if not diff <= 0.05:
        raise SystemExit("cuda and cpu KA disagree on the small scene")

    # -- phase 5: the main path at full width ----------------------------------
    t0 = time.perf_counter()
    images, kps, truth, matches, scores = make_scene(
        np, seed=0, n_views=10, n_points=2000, W=1600, H=1200, margin=150)
    names = list(images)
    print(f"phase 5: scene of {len(names)} views, "
          f"{sum(len(v) for v in kps.values())} keypoints, "
          f"{len(matches)} pairs made in {time.perf_counter() - t0:.1f} s")
    sfm = PixSfM(device="cuda")
    kp0 = {k: v.copy() for k, v in kps.items()}
    err0 = gt_error(np, kp0, truth, names[1:])
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    t0 = time.perf_counter()
    kp1, out = sfm.run_ka(kps, images, matches=matches, scores=scores)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches}
    ka_s = float(out["time"][0])
    err1 = gt_error(np, kp1, truth, names[1:])
    moved = max(float(np.abs(kp1[n] - kp0[n]).max()) for n in names)
    c0, c1 = float(out["initial_cost"][0]), float(out["final_cost"][0])
    print(f"phase 5: run_ka {wall:.2f} s (extraction + graph "
          f"{wall - ka_s:.2f} s, KA {ka_s:.2f} s), "
          f"{out['num_problems'][0]} problems, LM iterations "
          f"{out['iterations'][0]}, cost {c0:.4f} -> {c1:.4f}, mean error "
          f"to ground truth {err0:.3f} -> {err1:.3f} px, largest move "
          f"{moved:.3f} px, launches {launches}")
    if not all(np.isfinite(kp1[n]).all() for n in names):
        raise SystemExit("non-finite keypoints")
    if not c1 < c0:
        raise SystemExit("KA cost did not fall")
    if not moved <= 4.0 + 1e-3:
        raise SystemExit("a keypoint left its bound")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel did not launch on the main path: "
                         f"{launches}")

    # -- phase 6: where the time goes (a second run, not counted) --------------
    from pixsfm_tpu_torch.extract import features_from_graph
    from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
    kps2 = {k: v.copy() for k, v in kp0.items()}
    t0 = time.perf_counter()
    graph = build_matching_graph(matches, scores)
    t_graph = time.perf_counter() - t0
    fm, t_ext, busy_ext, kern_ext, tab_ext = profile_stage(
        torch, lambda: features_from_graph(sfm.extractor, images, graph,
                                           kps2))
    _, t_ka, busy_ka, kern_ka, tab_ka = profile_stage(
        torch, lambda: sfm.keypoint_adjuster.refine_multilevel(kps2, fm,
                                                               graph))
    print(f"phase 6 (under the profiler): graph {t_graph:.3f} s; "
          f"extraction {t_ext:.3f} s wall, {busy_ext:.3f} s device busy; "
          f"KA {t_ka:.3f} s wall, {busy_ka:.3f} s device busy "
          f"(idle share {1 - busy_ka / t_ka:.2f})")
    for stage, kern in (("extraction", kern_ext), ("KA", kern_ka)):
        for name, calls, dev_ms in kern[:6]:
            print(f"  {stage}: {dev_ms:9.3f} ms in {calls:5d} launches  "
                  f"{name[:90]}")
    in_situ_ka = _in_situ(kern_ka, {"K1": "interp_kernel",
                                    "K2": "pcg_kernel"}, launches)
    _took_variant(kern_ka, "K2", "pcg_kernel_register", "pcg_kernel_general")
    print(f"phase 6: in-situ device ms per launch {in_situ_ka}")
    if args.profile_out:
        out_dir = Path(args.profile_out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_profile.txt").write_text(
            f"{smi}\n\n== extraction ==\n{tab_ext}\n\n== KA ==\n"
            f"{tab_ka}\n")

    # -- phase 7: K3a/b/c against their plain versions -----------------------
    # the BA main path's shape: 56 views, one SIMPLE_RADIAL camera, T = 8,
    # 40 000 points padded to 65 536, ~240 000 observations
    n_views, n_pts = 56, 40000
    k3 = check_k3(torch, schur_cuda, T=8, I=n_views, Nc=1, k=4, P=65536,
                  n_obs=240000)
    variant = schur_cuda.matvec_variant(8, 4, n_views, 1, 65536)
    rhs_variant = schur_cuda.rhs_variant(8, 4, n_views, 1, 65536)
    print(f"K3a / K3b variants at the BA path's shape: {variant} / "
          f"{rhs_variant}")
    if variant != "fused1/shared" or rhs_variant != "fused1/shared":
        raise SystemExit("K3a or K3b did not take its fused variant at the "
                         "BA path's shape")
    onepass = k3.pop("K3b onepass")
    k3["K3b"].update(variant=rhs_variant, onepass_ms=onepass["ms"])
    check_k3_edges(torch, schur_cuda)
    # K1 at the BA path's shape: one chunk of 8192 observations over one
    # bf16 patch per observation (~240 000)
    k1_ba = check_k1(torch, interpolate_cuda, n_patches=240000,
                     n_queries=8192, dtypes=(torch.bfloat16,))
    torch.cuda.empty_cache()

    # -- phase 8: small BA on the grid layout, cuda against cpu ----------------
    c_dev, x_dev, s_dev = small_ba(torch, np, "cuda")
    c_cpu, x_cpu, s_cpu = small_ba(torch, np, "cpu")
    dx = float(np.abs(x_dev - x_cpu).max())
    print(f"phase 8: small BA (grid layout, {s_dev['iterations']} LM / "
          f"{s_dev['cg_iterations']} CG iterations on cuda, "
          f"{s_cpu['cg_iterations']} CG on cpu): cost cuda {c_dev:.6f} / cpu "
          f"{c_cpu:.6f}, max |xyz(cuda) - xyz(cpu)| = {dx:.2e} (limits: cost "
          f"rtol 1e-4, xyz 1e-3)")
    if not (abs(c_dev - c_cpu) <= 1e-4 * abs(c_cpu) and dx <= 1e-3):
        raise SystemExit("cuda and cpu BA disagree on the small scene")

    # -- phase 9: the BA main path at full size --------------------------------
    t0 = time.perf_counter()
    rec, views, truth = make_ba_scene(torch, np, seed=11, n_views=n_views,
                                      n_points=n_pts, W=1600, H=1200,
                                      device="cuda")
    n_obs = sum(p.track_length for p in rec.points3D.values())
    print(f"phase 9: scene of {len(views)} views, {len(rec.points3D)} "
          f"points, {n_obs} observations made in "
          f"{time.perf_counter() - t0:.1f} s")
    rec_profile = rec.copy()
    rec_lowmem = rec.copy()          # phase 19(c) starts from the same state
    ba_conf = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_ITERATIONS}}}}}
    sfm_ba = PixSfM(ba_conf, device="cuda")
    err0 = point_error(np, rec, truth)
    reproj0 = rec.mean_reprojection_error()
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    mem_base_ba = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_ba = sfm_ba.run_ba(rec, views)
    torch.cuda.synchronize()
    wall_ba = time.perf_counter() - t0
    mem_peak_ba = torch.cuda.max_memory_allocated() - mem_base_ba
    launches_ba = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                   "K3a": schur_cuda.launches["matvec"],
                   "K3b": schur_cuda.launches["rhs"],
                   "K3c": schur_cuda.launches["backsub"]}
    ob = {k: v[0] for k, v in out_ba.items()}
    t_solve, t_refs = ob["time"], ob["references_time"]
    err1 = point_error(np, rec, truth)
    reproj1 = rec.mean_reprojection_error()
    print(f"phase 9: run_ba {wall_ba:.2f} s (extraction + packing "
          f"{wall_ba - t_refs - t_solve:.2f} s, references {t_refs:.2f} s, "
          f"BA solve {t_solve:.2f} s), grid T {ob['obs_grid_T']}, LM "
          f"iterations {ob['iterations']}, CG iterations "
          f"{ob['cg_iterations']}, cost {ob['initial_cost']:.4f} -> "
          f"{ob['final_cost']:.4f}, point error to truth {err0:.5f} -> "
          f"{err1:.5f}, reprojection error {reproj0:.3f} -> {reproj1:.3f} "
          f"px, launches {launches_ba}, peak device memory "
          f"{mem_peak_ba / 1e9:.2f} GB above the {mem_base_ba / 1e9:.2f} GB "
          f"allocated before")
    finite = all(np.isfinite(im.qvec).all() and np.isfinite(im.tvec).all()
                 for im in rec.images.values()) and all(
        np.isfinite(p.xyz).all() for p in rec.points3D.values())
    if not finite:
        raise SystemExit("non-finite poses or points after BA")
    if ob["obs_grid_T"] != 8:
        raise SystemExit(f"the grid regime was not chosen: {ob}")
    if not ob["final_cost"] < ob["initial_cost"]:
        raise SystemExit("BA cost did not fall")
    if min(launches_ba[k] for k in ("K1", "K3a", "K3b", "K3c")) <= 0:
        raise SystemExit(f"a kernel did not launch on the BA main path: "
                         f"{launches_ba}")

    # -- phase 10: where the BA time goes (a second run, not counted) ---------
    from pixsfm_tpu_torch.extract import features_from_reconstruction
    sfm_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    fm_ba, t_exb, busy_exb, kern_exb, tab_exb = profile_stage(
        torch, lambda: features_from_reconstruction(sfm_prof.extractor,
                                                    rec_profile, views))
    out_p, t_bap, busy_bap, kern_bap, tab_bap = profile_stage(
        torch, lambda: sfm_prof.bundle_adjuster.refine_multilevel(
            rec_profile, fm_ba))
    del fm_ba
    print(f"phase 10 (under the profiler): extraction {t_exb:.3f} s wall, "
          f"{busy_exb:.3f} s device busy; references + BA "
          f"({BA_PROFILE_ITERATIONS} LM iterations, "
          f"{out_p['cg_iterations'][0]} CG iterations) {t_bap:.3f} s wall, "
          f"{busy_bap:.3f} s device busy (idle share "
          f"{1 - busy_bap / t_bap:.2f}); references "
          f"{out_p['references_time'][0]:.3f} s, BA solve "
          f"{out_p['time'][0]:.3f} s")
    for stage, kern in (("extraction", kern_exb), ("BA", kern_bap)):
        for name, calls, dev_ms in kern[:8]:
            print(f"  {stage}: {dev_ms:9.3f} ms in {calls:6d} launches  "
                  f"{name[:90]}")
    in_situ = _in_situ(kern_bap, {"K3a": "matvec_kernel",
                                  "K3b": "rhs_kernel",
                                  "K3c": "backsub_kernel",
                                  "K1": "interp_kernel"}, launches_ba)
    print(f"phase 10: in-situ device ms per launch {in_situ}")
    _took_variant(kern_bap, "K3b", "rhs_kernel_fused", "rhs_kernel_onepass")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== BA extraction ==\n{tab_exb}\n\n== BA "
                     f"references + solve ({BA_PROFILE_ITERATIONS} LM "
                     f"iterations) ==\n{tab_bap}\n")

    # -- phase 11: the triangulation main path at full width -----------------
    # phase 9's patches go first (~16 GB); its decoded views, truth and
    # starting state stay on the host for phase 19
    del rec, rec_profile, sfm_ba, sfm_prof
    torch.cuda.empty_cache()
    import tempfile
    from pixsfm_tpu_torch.keypoint_adjustment import build_matching_graph
    from pixsfm_tpu_torch.ops.schur import BAOptions
    from pixsfm_tpu_torch.sfm.model import Reconstruction
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_reconstruction
    from pixsfm_tpu_torch.util.misc import bucket
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    n_tri_pts = 8000
    _, views_t, truth_t = make_ba_scene(
        torch, np, seed=5, n_views=24, n_points=n_tri_pts, W=1600, H=1200,
        device="cuda", min_track=3, max_track=8, noise_px=1.0)
    kps_t, matches_t, scores_t, reference = triangulation_inputs(np, truth_t)
    reference.write(tmp / "reference")
    reference = Reconstruction.read(tmp / "reference")
    print(f"phase 11: scene of {len(views_t)} views, {n_tri_pts} points, "
          f"{sum(len(v) for v in kps_t.values())} keypoints, "
          f"{len(matches_t)} pairs made in {time.perf_counter() - t0:.1f} s")
    # the points the unrefined keypoints give (no kernel: not counted)
    rec_raw = triangulate_reconstruction(
        reference, build_matching_graph(matches_t, scores_t),
        {k: v.copy() for k, v in kps_t.items()}, device="cuda")
    err_raw = triangulated_error(np, rec_raw, truth_t)
    tri_conf = {"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_ITERATIONS}}}}}
    sfm_tri = PixSfM(tri_conf, device="cuda")
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    rec_t, out_t = sfm_tri._triangulation(
        tmp / "triangulated", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    launches_tri = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                    "K3a": schur_cuda.launches["matvec"],
                    "K3b": schur_cuda.launches["rhs"],
                    "K3c": schur_cuda.launches["backsub"]}
    oka = {k: v[0] for k, v in out_t["KA"].items()}
    oba = {k: v[0] for k, v in out_t["BA"].items()}
    t_tri = out_t["triangulation"]["time"]
    n_tri = len(rec_t.points3D)
    survived = n_tri / n_tri_pts
    track_lens = np.array([p.track_length for p in rec_t.points3D.values()])
    n_obs_t = int(track_lens.sum())
    n_pairs = int((track_lens ** 2).sum())
    np_pad_chunk = bucket(n_tri, minimum=4) * BAOptions().obs_chunk
    err_tri = triangulated_error(np, rec_t, truth_t)
    t_rest = wall_t - oka["time"] - t_tri - oba["references_time"] \
        - oba["time"]
    print(f"phase 11: triangulation path {wall_t:.2f} s (graph, extraction "
          f"and packing {t_rest:.2f} s, KA {oka['time']:.2f} s, "
          f"triangulation {t_tri:.2f} s, references "
          f"{oba['references_time']:.2f} s, BA solve {oba['time']:.2f} s); "
          f"KA {oka['iterations']} LM iterations, cost "
          f"{oka['initial_cost']:.4f} -> {oka['final_cost']:.4f}; "
          f"{n_tri} / {n_tri_pts} tracks triangulated ({survived:.4f}), "
          f"{n_obs_t} observations; BA regime {oba['linear_solver']} with "
          f"grid T {oba['obs_grid_T']} ({n_pairs} track pairs, Np_pad * "
          f"obs_chunk = {np_pad_chunk}), {oba['iterations']} LM / "
          f"{oba['cg_iterations']} CG iterations, cost "
          f"{oba['initial_cost']:.4f} -> {oba['final_cost']:.4f}; point "
          f"error to truth {err_raw:.5f} (unrefined keypoints) -> "
          f"{err_tri:.5f} (after KA and BA); launches {launches_tri}")
    if not all(np.isfinite(p.xyz).all() for p in rec_t.points3D.values()):
        raise SystemExit("non-finite points after the triangulation path")
    if not (oba["linear_solver"] == "cg" and oba["obs_grid_T"] == 0
            and n_pairs > 20_000 and np_pad_chunk <= 1 << 28):
        raise SystemExit("the triangulation path's BA did not take the flat "
                         "CG layout")
    if not oba["final_cost"] < oba["initial_cost"]:
        raise SystemExit("BA cost did not fall on the triangulation path")
    if not survived >= TRI_MIN_SURVIVING:
        raise SystemExit(f"only {survived:.4f} of the tracks survived "
                         f"triangulation (limit {TRI_MIN_SURVIVING})")
    if min(launches_tri["K1"], launches_tri["K2"]) <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the triangulation "
                         f"path: {launches_tri}")
    # where the time goes: the path again under the profiler, BA capped at
    # BA_PROFILE_ITERATIONS (a second run, not counted)
    sfm_tri_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    (_, out_p), t_trp, busy_trp, kern_trp, tab_trp = profile_stage(
        torch, lambda: sfm_tri_prof._triangulation(
            tmp / "triangulated_profile", reference, views_t,
            {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t))
    print(f"phase 11 (under the profiler, {BA_PROFILE_ITERATIONS} BA "
          f"iterations): {t_trp:.3f} s wall, {busy_trp:.3f} s device busy "
          f"(idle share {1 - busy_trp / t_trp:.2f}); KA "
          f"{out_p['KA']['time'][0]:.3f} s, triangulation "
          f"{out_p['triangulation']['time']:.3f} s, references "
          f"{out_p['BA']['references_time'][0]:.3f} s, BA solve "
          f"{out_p['BA']['time'][0]:.3f} s")
    for name, calls, dev_ms in kern_trp[:10]:
        print(f"  triangulation path: {dev_ms:9.3f} ms in {calls:6d} "
              f"launches  {name[:90]}")
    in_situ_tri = _in_situ(kern_trp, {"K1": "interp_kernel",
                                      "K2": "pcg_kernel"}, launches_tri)
    print(f"phase 11: in-situ device ms per launch {in_situ_tri}")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            fh.write(f"\n\n== triangulation path ({BA_PROFILE_ITERATIONS} "
                     f"BA iterations) ==\n{tab_trp}\n")
    # the triangulation stage's parts: the track labels (host union-find)
    # and the batched DLT on the card (CUDA events), against the CPU
    from pixsfm_tpu_torch.base.graph import compute_track_labels
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_batch
    graph_t = build_matching_graph(matches_t, scores_t)
    t0 = time.perf_counter()
    compute_track_labels(graph_t)
    t_labels = time.perf_counter() - t0
    A_t = dlt_stack(torch, np, truth_t)
    svd_ms = _time_ms(lambda: triangulate_batch(A_t), reps=5, warmup=1)
    dlt_diff = float((triangulate_batch(A_t).cpu()
                      - triangulate_batch(A_t.cpu())).abs().max())
    print(f"phase 11: triangulation stage parts: track labels (host) "
          f"{t_labels:.3f} s; batched DLT on [{A_t.shape[0]}, "
          f"{A_t.shape[1]}, 4] {svd_ms:.3f} ms on the card, max |X(cuda) - "
          f"X(cpu)| = {dlt_diff:.2e} (scene units)")
    if not dlt_diff <= 1e-4:
        raise SystemExit("the batched DLT disagrees between cuda and cpu")
    del rec_raw, rec_t, A_t
    torch.cuda.empty_cache()
    # K1 at the triangulation path's BA shape: one chunk of 8192
    # observations over one bf16 patch per observation
    k1_tri = check_k1(torch, interpolate_cuda, n_patches=n_obs_t,
                      n_queries=8192, dtypes=(torch.bfloat16,))

    # -- phase 12: the dense step, cuda against cpu ----------------------------
    rec_d, views_d, _ = make_ba_scene(torch, np, seed=13, n_views=12,
                                      n_points=1500, W=640, H=480,
                                      device="cuda", min_track=3,
                                      max_track=3)
    for label, rec_in in (("one model", rec_d),
                          ("mixed models", mixed_models(rec_d))):
        o_dev, x_dev, w_dev = dense_ba(torch, np, rec_in, views_d, "cuda",
                                       tmp)
        o_cpu, x_cpu, w_cpu = dense_ba(torch, np, rec_in, views_d, "cpu",
                                       tmp)
        dx = float(np.abs(x_dev - x_cpu).max())
        n_models = len({c.model for c in rec_in.cameras.values()})
        print(f"phase 12: dense step, {label} ({n_models}), "
              f"{len(rec_in.images)} views, {len(rec_in.points3D)} points: "
              f"regime {o_dev['linear_solver']} / {o_cpu['linear_solver']}, "
              f"{o_dev['iterations']} LM iterations, cost cuda "
              f"{o_dev['initial_cost']:.6f} -> {o_dev['final_cost']:.6f} / "
              f"cpu {o_cpu['final_cost']:.6f}, max |xyz(cuda) - xyz(cpu)| = "
              f"{dx:.2e} (limits: cost rtol 1e-4, xyz 1e-3); "
              f"refine_reconstruction {w_dev:.2f} s on cuda (BA solve "
              f"{o_dev['time']:.3f} s), {w_cpu:.2f} s on cpu (BA solve "
              f"{o_cpu['time']:.3f} s)")
        if not (o_dev["linear_solver"] == o_cpu["linear_solver"] == "dense"):
            raise SystemExit("the small scene did not take the dense step")
        if not (abs(o_dev["final_cost"] - o_cpu["final_cost"])
                <= 1e-4 * abs(o_cpu["final_cost"]) and dx <= 1e-3):
            raise SystemExit(f"cuda and cpu dense BA disagree ({label})")
        if not o_dev["final_cost"] < o_dev["initial_cost"]:
            raise SystemExit(f"dense BA cost did not fall ({label})")
    del views_d

    # -- phase 13: keypoint_adjuster on a COLMAP database ----------------------
    import PIL.Image
    from pixsfm_tpu_torch import refine_colmap
    from pixsfm_tpu_torch.util.colmap import read_keypoints_from_db
    (tmp / "images").mkdir()
    for name, img in images.items():
        PIL.Image.fromarray(img).save(tmp / "images" / name)
    kp32 = {n: v.astype(np.float32) for n, v in kp0.items()}
    write_database(np, tmp / "db.db", kp32, matches, W=1600, H=1200)
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    t0 = time.perf_counter()
    refine_colmap.main(["keypoint_adjuster", "--database_path",
                        str(tmp / "db.db"), "--output_path",
                        str(tmp / "db_out.db"), "--image_dir",
                        str(tmp / "images")])
    wall_db = time.perf_counter() - t0
    launches_db = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches}
    kp_db = read_keypoints_from_db(tmp / "db_out.db")
    kp_ref, _ = sfm.run_ka({n: v.astype(np.float64) for n, v in kp32.items()},
                           images, matches=matches)
    diff_db = max(float(np.abs(kp_db[n] - kp_ref[n]).max()) for n in kp_ref)
    print(f"phase 13: keypoint_adjuster on a COLMAP database of phase 5's "
          f"scene {wall_db:.2f} s, launches {launches_db}; max |kp(database) "
          f"- kp(run_ka)| = {diff_db:.2e} px (limit {DB_KP_ATOL} px)")
    if not diff_db <= DB_KP_ATOL or min(launches_db.values()) <= 0:
        raise SystemExit("the database keypoint adjuster disagrees with "
                         "run_ka")

    # -- phase 14: PnP on the card against the CPU -----------------------------
    from pixsfm_tpu_torch.localization import (absolute_pose_estimation,
                                               absolute_pose_estimation_batch)
    queries = pnp_queries(np, seed=14, n_queries=PNP_QUERIES)
    sizes_q = [len(q["points2D"]) for q in queries]
    for polish in (False, True):
        t0 = time.perf_counter()
        o_dev = absolute_pose_estimation_batch(queries, polish=polish,
                                               device="cuda")
        torch.cuda.synchronize()
        w_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        o_cpu = absolute_pose_estimation_batch(queries, polish=polish,
                                               device="cpu")
        w_cpu = time.perf_counter() - t0
        tol = PNP_POLISHED_TOL if polish else PNP_UNPOLISHED_TOL
        rots, trans = [], []
        worst_n = worst_c = 0
        for a, b, q in zip(o_dev, o_cpu, queries):
            if a["success"] != b["success"]:
                raise SystemExit("PnP success differs between cuda and cpu")
            if not b["success"]:
                continue
            ang, dt = pose_agreement(np, a, b, q["points3D"])
            rots.append(ang)
            trans.append(dt)
            worst_n = max(worst_n, abs(a["num_inliers"] - b["num_inliers"]))
            worst_c = max(worst_c, unexplained(np, a, b, q),
                          unexplained(np, b, a, q))
        rots, trans = np.asarray(rots), np.asarray(trans)
        n_ok = len(rots)
        print(f"phase 14: PnP of {len(queries)} queries ({min(sizes_q)}-"
              f"{max(sizes_q)} correspondences), polish={polish}: "
              f"{n_ok} succeed; cuda {w_dev:.2f} s, cpu {w_cpu:.2f} s; "
              f"largest |inliers(cuda) - inliers(cpu)| {worst_n}, largest "
              f"count of one device's inliers the other's pose leaves out "
              f"{worst_c}; rotation median {np.median(rots):.2e} / largest "
              f"{rots.max():.2e} rad, translation median "
              f"{np.median(trans):.2e} / largest {trans.max():.2e} relative; "
              f"{int((rots <= 1e-6).sum())} of {n_ok} within 1e-6 rad "
              f"(limits 1, 1, {tol:g}, {tol:g})")
        if not (worst_n <= 1 and worst_c <= 1 and rots.max() <= tol
                and trans.max() <= tol):
            raise SystemExit(f"PnP disagrees between cuda and cpu "
                             f"(polish={polish})")
    # one stage-1 program (P3P, 256 samples) and one stage-2 program (the
    # full families, 512 samples) on one query of 500 correspondences, each
    # timed and its launches counted under the profiler
    from pixsfm_tpu_torch.localization import pnp
    q = pnp_queries(np, seed=140, n_queries=1, n=500)[0]
    xy_q = np.asarray(q["points2D"], np.float64)
    group = {(q["camera"].model, 512): [(0, xy_q, q["points3D"],
                                         q["camera"])]}
    pnp_calls = {}
    for label, H, fam in (("stage 1", 256, "p3p"), ("stage 2", 512, "full")):
        def one(H=H, fam=fam):
            return pnp._run_pnp_groups(group, H, 12.0,
                                       np.random.default_rng(0),
                                       (torch.device("cuda"),), fam)
        one()
        _, t_call, busy_call, kern_call, _ = profile_stage(torch, one)
        t0 = time.perf_counter()
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        wall_call = (time.perf_counter() - t0) / 3
        n_launch = sum(c for _, c, _ in kern_call)
        pnp_calls[label] = dict(wall_s=wall_call, launches=n_launch,
                                device_busy_s=busy_call)
        print(f"phase 14: one {label} PnP program ({fam}, {H} samples, "
              f"{len(xy_q)} correspondences): {wall_call * 1e3:.1f} ms wall, "
              f"{n_launch} kernel launches, {busy_call * 1e3:.1f} ms device "
              f"busy (idle share {1 - busy_call / t_call:.2f} under the "
              f"profiler)")

    # -- phase 15: the incremental mapper on the card against the CPU ---------
    from pixsfm_tpu_torch.sfm.mapper import incremental_mapping
    graph_r, kps_r, sizes_r = ring_scene(np, n_views=12, n_points=300)
    maps = {}
    for device in ("cuda", "cpu"):
        st = {}
        t0 = time.perf_counter()
        rec_m = incremental_mapping(graph_r, {k: v.copy() for k, v in
                                              kps_r.items()}, sizes_r,
                                    device=device, stats=st)
        maps[device] = (rec_m, st, time.perf_counter() - t0)
    (r_d, s_d, w_d), (r_c, s_c, w_c) = maps["cuda"], maps["cpu"]
    reg_d = {i for i, im in r_d.images.items() if im.registered}
    reg_c = {i for i, im in r_c.images.items() if im.registered}
    init_d = s_d["init_pairs"][s_d["best_attempt"]]
    init_c = s_c["init_pairs"][s_c["best_attempt"]]
    rot_m, cen_m = aligned_errors(np, r_d, r_c, reg_c & reg_d)
    n_pd, n_pc = len(r_d.points3D), len(r_c.points3D)
    print(f"phase 15: mapper on a ring of {len(kps_r)} views / 300 points: "
          f"cuda {w_d:.2f} s ({s_d['attempts']} attempts, "
          f"{s_d['registrations']} registrations, {s_d['pnp_calls']} PnP "
          f"calls {s_d['pnp_time']:.2f} s, {s_d['ba_calls']} BA calls "
          f"{s_d['ba_time']:.2f} s), cpu {w_c:.2f} s ({s_c['attempts']} "
          f"attempts); registered {len(reg_d)} / {len(reg_c)}, initial pair "
          f"{init_d} / {init_c}, points {n_pd} / {n_pc}; after alignment "
          f"rotations within {rot_m.max():.2e} deg, centres within "
          f"{cen_m.max():.2e} of the extent (limits 0.05 deg, 1e-3)")
    if not (reg_d == reg_c and init_d == init_c
            and abs(n_pd - n_pc) <= 0.02 * n_pc
            and rot_m.max() < 0.05 and cen_m.max() < 1e-3):
        raise SystemExit("the mapper disagrees between cuda and cpu")

    # -- phase 16: the reconstruction main path at full width -----------------
    t0 = time.perf_counter()
    views_r, truth_r = make_fold_scene(
        torch, np, seed=16, n_views=24, n_points=RECON_POINTS, W=1600,
        H=1200, device="cuda", noise_px=RECON_NOISE_PX)
    kps_rc, matches_rc, scores_rc, _ = triangulation_inputs(np, truth_r)
    print(f"phase 16: fold scene of {len(views_r)} views, {RECON_POINTS} "
          f"points, {sum(len(v) for v in kps_rc.values())} keypoints, "
          f"{len(matches_rc)} pairs, keypoint noise {RECON_NOISE_PX} px, "
          f"made in {time.perf_counter() - t0:.1f} s")
    sfm_rc = PixSfM(tri_conf, device="cuda")
    torch.cuda.synchronize()
    interpolate_cuda.launches = 0
    cg_cuda.launches = 0
    for name in schur_cuda.launches:
        schur_cuda.launches[name] = 0
    t0 = time.perf_counter()
    rec_r, out_r = sfm_rc._reconstruction(
        tmp / "reconstruction", views_r,
        {k: v.copy() for k, v in kps_rc.items()}, matches_rc, scores_rc)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    launches_rc = {"K1": interpolate_cuda.launches, "K2": cg_cuda.launches,
                   "K3a": schur_cuda.launches["matvec"],
                   "K3b": schur_cuda.launches["rhs"],
                   "K3c": schur_cuda.launches["backsub"]}
    oka_r = {k: v[0] for k, v in out_r["KA"].items()}
    oba_r = {k: v[0] for k, v in out_r["BA"].items()}
    osfm = out_r["SfM"]
    reg_r = [i for i, im in rec_r.images.items() if im.registered]
    rot_r, cen_r = aligned_errors(np, rec_r, truth_r, reg_r)
    n_obs_r = sum(p.track_length for p in rec_r.points3D.values())
    t_rest = wall_r - oka_r["time"] - osfm["time"] \
        - oba_r["references_time"] - oba_r["time"]
    print(f"phase 16: reconstruction path {wall_r:.2f} s (graph, extraction "
          f"and packing {t_rest:.2f} s, KA {oka_r['time']:.2f} s, mapper "
          f"{osfm['time']:.2f} s, references {oba_r['references_time']:.2f} "
          f"s, BA solve {oba_r['time']:.2f} s); KA {oka_r['iterations']} LM "
          f"iterations, cost {oka_r['initial_cost']:.4f} -> "
          f"{oka_r['final_cost']:.4f}; mapper: {osfm['attempts']} attempts "
          f"(winner {osfm['best_attempt']}), {osfm['registrations']} "
          f"registrations, {osfm['pnp_calls']} PnP calls "
          f"{osfm['pnp_time']:.2f} s, {osfm['ba_calls']} geometric-BA calls "
          f"{osfm['ba_time']:.2f} s, {osfm['triangulations']} "
          f"triangulations {osfm['triangulation_time']:.2f} s; "
          f"{len(reg_r)} / {len(views_r)} views registered, "
          f"{len(rec_r.points3D)} points, {n_obs_r} observations; BA "
          f"regime {oba_r['linear_solver']}, {oba_r['iterations']} LM / "
          f"{oba_r['cg_iterations']} CG iterations, cost "
          f"{oba_r['initial_cost']:.4f} -> {oba_r['final_cost']:.4f}; after "
          f"a similarity to the truth rotations within {rot_r.max():.3f} "
          f"deg, centres within {cen_r.max():.2e} of the extent (limits "
          f"0.5 deg, 1e-2); launches {launches_rc}")
    if len(reg_r) < len(views_r) - 1:
        raise SystemExit(f"only {len(reg_r)} of {len(views_r)} views "
                         f"registered")
    if not (rot_r.max() < 0.5 and cen_r.max() < 1e-2):
        raise SystemExit("the reconstruction is off the truth")
    if not oba_r["final_cost"] < oba_r["initial_cost"]:
        raise SystemExit("BA cost did not fall on the reconstruction path")
    if min(launches_rc["K1"], launches_rc["K2"]) <= 0:
        raise SystemExit(f"K1 or K2 did not launch on the reconstruction "
                         f"path: {launches_rc}")
    # where the time goes, under the profiler (not counted): the KA and the
    # final BA again (BA capped at BA_PROFILE_ITERATIONS), and one call of
    # each of the mapper's device stages on the final map (PnP of a view,
    # the retriangulation, a geometric BA). The whole path under the
    # profiler is ~2.4 million launches, whose tables take ~20 minutes to
    # build; the mapper's device-busy time is estimated from the single
    # calls times their counts (calls on the final map are the largest, so
    # the estimate is an upper bound on busy time).
    from pixsfm_tpu_torch.bundle_adjustment import GeometricBundleAdjuster
    from pixsfm_tpu_torch.sfm.mapper import mapper_ba_conf
    from pixsfm_tpu_torch.sfm.triangulation import triangulate_tracks
    sfm_rc_prof = PixSfM({"mapping": {"BA": {"optimizer": {"solver": {
        "max_num_iterations": BA_PROFILE_ITERATIONS}}}}}, device="cuda")
    graph_rc = build_matching_graph(matches_rc, scores_rc)
    kps_p = {k: v.copy() for k, v in kps_rc.items()}
    fm_rc = features_from_graph(sfm_rc_prof.extractor, views_r, graph_rc,
                                kps_p)
    prof_rc = {}
    prof_rc["KA"] = profile_stage(torch, lambda: sfm_rc_prof.keypoint_adjuster
                                  .refine_multilevel(kps_p, fm_rc, graph_rc))
    del fm_rc
    rec_p = rec_r.copy()
    prof_rc["references + BA"] = profile_stage(
        torch, lambda: sfm_rc_prof.run_ba(rec_p, views_r))
    im0 = rec_r.images[reg_r[len(reg_r) // 2]]
    sel = np.nonzero(im0.point3D_ids >= 0)[0]
    X0 = np.stack([rec_r.points3D[int(p)].xyz for p in im0.point3D_ids[sel]])
    cam0 = rec_r.cameras[im0.camera_id]
    prof_rc["PnP"] = profile_stage(torch, lambda: absolute_pose_estimation(
        rec_r.images[im0.image_id].xys[sel], X0, cam0, polish=False,
        device="cuda"))
    rec_t2 = rec_r.copy()
    rec_t2.points3D.clear()
    for im in rec_t2.images.values():
        im.point3D_ids[:] = -1
    labels_rc = compute_track_labels(graph_rc)
    prof_rc["triangulation"] = profile_stage(torch, lambda: triangulate_tracks(
        rec_t2, graph_rc, {im.name: im.xys for im in rec_r.images.values()},
        track_labels=labels_rc, device="cuda"))
    ba_geo = GeometricBundleAdjuster(mapper_ba_conf(False), device="cuda")
    rec_g = rec_r.copy()
    prof_rc["geometric BA"] = profile_stage(torch,
                                            lambda: ba_geo.refine(rec_g))
    kern_rcp = {}
    for stage, (_, t_p, busy_p, kern_p, tab_p) in prof_rc.items():
        n_p = sum(c for _, c, _ in kern_p)
        print(f"phase 16 (under the profiler): {stage} {t_p:.3f} s wall, "
              f"{busy_p:.3f} s device busy (idle share "
              f"{1 - busy_p / t_p:.2f}), {n_p} kernel launches")
        for name, calls, dev_ms in kern_p:
            c0, ms0 = kern_rcp.get(name, (0, 0.0))
            kern_rcp[name] = (c0 + calls, ms0 + dev_ms)
    busy_map = sum(prof_rc[stage][2] * osfm[key] for stage, key in (
        ("PnP", "pnp_calls"), ("triangulation", "triangulations"),
        ("geometric BA", "ba_calls")))
    print(f"phase 16: the mapper's device busy time, estimated from the "
          f"single calls times their counts: {busy_map:.2f} s of "
          f"{osfm['time']:.2f} s (idle share at least "
          f"{1 - busy_map / osfm['time']:.2f})")
    kern_rcp = sorted(((n, c, ms) for n, (c, ms) in kern_rcp.items()),
                      key=lambda k: -k[2])
    for name, calls, dev_ms in kern_rcp[:12]:
        print(f"  reconstruction path: {dev_ms:9.3f} ms in {calls:7d} "
              f"launches  {name[:90]}")
    in_situ_rc = _in_situ(kern_rcp, {"K1": "interp_kernel",
                                     "K2": "pcg_kernel"}, launches_rc)
    print(f"phase 16: in-situ device ms per launch {in_situ_rc}")
    if args.profile_out:
        with open(Path(args.profile_out) / "chip_smoke_profile.txt",
                  "a") as fh:
            for stage, res in prof_rc.items():
                fh.write(f"\n\n== reconstruction path: {stage} ==\n"
                         f"{res[4]}\n")
    n_obs_rc = n_obs_r
    del views_r, rec_r, sfm_rc, sfm_rc_prof, prof_rc, rec_p, rec_g, rec_t2
    torch.cuda.empty_cache()
    k1_rc = check_k1(torch, interpolate_cuda, n_patches=n_obs_rc,
                     n_queries=8192, dtypes=(torch.bfloat16,))

    # -- phase 17: dsift on the triangulation path -----------------------------
    from pixsfm_tpu_torch.config import load_config
    sfm_ds = PixSfM(load_config("dsift"), device="cuda")
    t0 = time.perf_counter()
    rec_ds, out_ds = sfm_ds._triangulation(
        tmp / "triangulated_dsift", reference, views_t,
        {k: v.copy() for k, v in kps_t.items()}, matches_t, scores_t)
    torch.cuda.synchronize()
    wall_ds = time.perf_counter() - t0
    err_ds = triangulated_error(np, rec_ds, truth_t)
    oka_ds = {k: v[0] for k, v in out_ds["KA"].items()}
    oba_ds = {k: v[0] for k, v in out_ds["BA"].items()}
    print(f"phase 17: the triangulation path with configs/dsift.yaml "
          f"{wall_ds:.2f} s (KA {oka_ds['time']:.2f} s, {oka_ds['iterations']} "
          f"LM iterations, cost {oka_ds['initial_cost']:.4f} -> "
          f"{oka_ds['final_cost']:.4f}; BA {oba_ds['iterations']} LM "
          f"iterations, cost {oba_ds['initial_cost']:.4f} -> "
          f"{oba_ds['final_cost']:.4f}); {len(rec_ds.points3D)} points; "
          f"point error to truth {err_raw:.5f} (unrefined keypoints) -> "
          f"{err_ds:.5f} with dsift, -> {err_tri:.5f} with S2DNet (phase 11)")
    if not all(np.isfinite(p.xyz).all() for p in rec_ds.points3D.values()):
        raise SystemExit("non-finite points on the dsift triangulation path")
    if not (oka_ds["final_cost"] < oka_ds["initial_cost"]
            and oba_ds["final_cost"] <= oba_ds["initial_cost"]):
        raise SystemExit("dsift: a cost did not fall")
    tmp_dir.cleanup()

    # -- phase 18: query localization at full width ----------------------------
    del sfm_ds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_loc, k1_loc, in_situ_loc, loc_scene = localization_phase(
        torch, np, interpolate_cuda, profile_out=args.profile_out)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # -- phase 19: the low_memory preset -----------------------------------
    (launches_lm, launches_lm_ba, launches_lm_tri, k1_lm,
     in_situ_lm) = low_memory_phase(
        torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
        schur_cuda, (rec_lowmem, views, truth),
        (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
         err_tri, n_tri_pts), mem_peak_ba, profile_out=args.profile_out)
    del rec_lowmem, views, truth

    # -- phase 20: the photometric preset -------------------------------------
    (launches_ph, launches_ph_tri, launches_ph_ba, k1_ph,
     in_situ_ph) = photometric_phase(
        torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
        schur_cuda, (reference, views_t, kps_t, matches_t, scores_t, truth_t,
                     err_raw, err_tri, n_tri_pts),
        profile_out=args.profile_out)

    # -- phase 21: the ETH3D evaluation flow --------------------------------
    tmp_e3 = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    scene_e3 = Path(tmp_e3.name) / "scene"
    gt_e3 = make_eth3d_scene(Path(tmp_e3.name))
    (launches_e3, launches_e3_dense, k1_e3_dense, launches_vgg, vgg_by_width,
     in_situ_e3, in_situ_vgg) = eth3d_phase(
        torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
        schur_cuda, scene_e3, gt_e3, profile_out=args.profile_out)

    # -- phase 22: the detector-free ETH3D path (LoFTR) ----------------------
    launches_lf = loftr_phase(torch, np, PixSfM, load_config,
                              interpolate_cuda, cg_cuda, schur_cuda,
                              scene_e3, gt_e3)
    tmp_e3.cleanup()

    # -- phase 23: every interpolation config and solver option -------------
    t0 = time.perf_counter()
    launches_op_a, launches_op_b, launches_op_c, k1_op = options_phase(
        torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
        schur_cuda, (reference, views_t, kps_t, matches_t, scores_t,
                     truth_t, err_raw, err_tri, n_tri_pts), loc_scene)
    launches_op = {k: launches_op_a[k] + launches_op_b[k] + launches_op_c[k]
                   for k in launches_op_a}
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")

    # -- phase 24: sharding over a device mesh that repeats the card --------
    launches_sh, launches_sh_by_run, k1_sh = sharded_phase(
        torch, np, PixSfM, load_config, interpolate_cuda, cg_cuda,
        schur_cuda, (images, kp0, matches, scores),
        (reference, views_t, kps_t, matches_t, scores_t, truth_t, err_raw,
         err_tri, n_tri_pts), loc_scene)
    del loc_scene

    # -- report ----------------------------------------------------------------
    # K1 runs on both paths at different shapes: one entry per path, each
    # with that path's launches and the figures measured at its shape
    paths = {"KA": launches, "BA": launches_ba,
             "triangulation": launches_tri, "reconstruction": launches_rc,
             "localization": launches_loc, "low_memory": launches_lm,
             "photometric": launches_ph, "eth3d": launches_e3,
             "eth3d_dense_query": {"K1": launches_e3_dense},
             "vggnet": launches_vgg, "eth3d_loftr": launches_lf,
             "interp_options": launches_op, "sharded": launches_sh}
    both = {k: sum(n.get(k, 0) for n in paths.values())
            for k in ("K1", "K2", "K3a", "K3b", "K3c")}
    print(f"launches on the main paths: {paths}")
    kernels_line = {"kernels": [
        dict(name="bicubic_window_interp_l2", path="KA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches["K1"], library_ms=None,
             in_situ_ms=in_situ_ka["K1"], **k1),
        dict(name="bicubic_window_interp_l2", path="BA", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_ba["K1"], library_ms=None,
             in_situ_ms=in_situ["K1"], **k1_ba),
        dict(name="bicubic_window_interp_l2", path="triangulation",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_tri["K1"], library_ms=None,
             in_situ_ms=in_situ_tri["K1"], **k1_tri),
        dict(name="bicubic_window_interp_l2", path="reconstruction",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_rc["K1"], library_ms=None,
             in_situ_ms=in_situ_rc["K1"], **k1_rc),
        dict(name="bicubic_window_interp_l2", path="localization",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_loc["K1"], library_ms=None,
             in_situ_ms=in_situ_loc["K1"], **k1_loc),
        dict(name="bicubic_window_interp_l2", path="low_memory",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_lm["K1"],
             launches_by_run={"run_ba (costmaps)": launches_lm_ba["K1"],
                              "triangulation": launches_lm_tri["K1"]},
             library_ms=None, in_situ_ms=in_situ_lm.get("K1"), **k1_lm),
        dict(name="bicubic_window_interp_l2", path="photometric",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_ph["K1"],
             launches_by_run={"triangulation": launches_ph_tri["K1"],
                              "run_ba (poses free)": launches_ph_ba["K1"]},
             library_ms=None, in_situ_ms=in_situ_ph.get("K1"), **k1_ph),
        dict(name="bicubic_window_interp_l2", path="eth3d", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_e3["K1"], library_ms=None,
             in_situ_ms=in_situ_e3.get("K1"),
             timed_at="the KA shape of phase 2 (C = 128)", **k1),
        dict(name="bicubic_window_interp_l2", path="eth3d_dense_query",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_e3_dense, library_ms=None, **k1_e3_dense),
        dict(name="bicubic_window_interp_l2", path="eth3d_loftr",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_lf["K1"], library_ms=None,
             timed_at="the KA shape of phase 2 (C = 128)", **k1),
        dict(name="bicubic_window_interp_l2", path="interp_options",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_op["K1"],
             launches_by_run={"node windows (23a)": launches_op_a["K1"],
                              "photometric KA (23b)": launches_op_b["K1"],
                              "full-mode localization (23c)":
                                  launches_op_c["K1"]},
             library_ms=None, **k1_op),
        dict(name="bicubic_window_interp_l2", path="sharded",
             route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
             replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
             launches=launches_sh["K1"],
             launches_by_run={k: v["K1"]
                              for k, v in launches_sh_by_run.items()},
             library_ms=None, **k1_sh),
        *(dict(name="bicubic_window_interp_l2", path="vggnet", channels=C,
               route="cuda",
               source="pixsfm_tpu_torch/kernels/csrc/interpolate.cu",
               replaces="pixsfm_tpu/ops/interpolate_pallas.py:186",
               launches=vgg_by_width.get(C, 0), library_ms=None,
               in_situ_ms=in_situ_vgg[C], **k1_wide[C])
          for C in (64, 256, 512)),
        dict(name="batched_jacobi_pcg", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/pcg.cu",
             replaces="pixsfm_tpu/ops/cg_pallas.py:88",
             launches=both["K2"],
             launches_by_path={n: c.get("K2", 0)
                               for n, c in paths.items()},
             library_ms=None, in_situ_ms=in_situ_ka["K2"], **k2),
        dict(name="schur_term_matvec", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:253",
             launches=both["K3a"],
             launches_by_path={n: c.get("K3a", 0)
                               for n, c in paths.items()},
             library_ms=None, in_situ_ms=in_situ["K3a"],
             in_situ_low_memory_ms=in_situ_lm.get("K3a"), **k3["K3a"]),
        dict(name="schur_rhs", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:280",
             launches=both["K3b"],
             launches_by_path={n: c.get("K3b", 0)
                               for n, c in paths.items()},
             library_ms=None, in_situ_ms=in_situ["K3b"],
             in_situ_low_memory_ms=in_situ_lm.get("K3b"), **k3["K3b"]),
        dict(name="schur_backsub", route="cuda",
             source="pixsfm_tpu_torch/kernels/csrc/schur.cu",
             replaces="pixsfm_tpu/ops/schur_pallas.py:302",
             launches=both["K3c"],
             launches_by_path={n: c.get("K3c", 0)
                               for n, c in paths.items()},
             library_ms=None, in_situ_ms=in_situ["K3c"],
             in_situ_low_memory_ms=in_situ_lm.get("K3c"), **k3["K3c"]),
    ]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

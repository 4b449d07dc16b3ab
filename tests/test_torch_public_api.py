"""Port parity: the public names of the JAX package that the port added
last, and a surface check that keeps the gap closed.

- ``test_public_surface_matches``: reads both packages' sources with
  ``ast`` (no import, no JAX): every name of a JAX module's ``__all__``,
  every re-export of a JAX ``__init__.py``, every public top-level function
  or class and every public method, property and field of a public class
  has a counterpart in the port's module of the same path (a class's
  members may come from a port base class), apart from :data:`DELIBERATE`,
  which ``ROADMAP.md`` section 3 names one for one.
- Each added name against its JAX counterpart on seeded inputs: geometry
  (float32, atol 1e-6), the functional losses (rtol 1e-6), the graph
  counts, ``Camera.mean_focal_length``, ``point_in_front``, the extractor's
  helpers and memory estimate, ``Reference.channels`` /
  ``has_observations``, ``LMState``'s fields, the config methods and
  ``add_common_args`` (all exact); the hloc writers round-trip both ways
  (the port writes and JAX reads, JAX writes and the port reads).
"""

import argparse
import ast
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_localization import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "pixsfm_tpu", ROOT / "pixsfm_tpu_torch"

# JAX-only surface, each named in ROADMAP.md section 3: whole modules (the
# Pallas kernels, which ops/*_cuda.py replace, and XLA's compile cache), and
# per module the names that have no counterpart
DELIBERATE = {
    "ops/cg_pallas.py": None,
    "ops/interpolate_pallas.py": None,
    "ops/schur_pallas.py": None,
    "util/jit_cache.py": None,
    "base/cameras.py": {"img_from_cam_jit", "cam_from_img_jit"},
    "base/interpolation.py": {
        "bicubic_window_eval_single", "interpolate_window_autodiff",
        "interpolate_residual", "interpolate_residual_with_grad",
        "interpolate_autodiff"},
    "features/models/d2net.py": {"load_torch_d2net"},
    "features/models/loftr.py": {"load_torch_loftr"},
    "features/models/r2d2.py": {"load_torch_r2d2"},
    "features/models/s2dnet.py": {"load_torch_s2dnet"},
    "features/models/superpoint.py": {"load_torch_superpoint"},
    "ops/lm.py": {"LMOptions.cg_backend"},
    "ops/schur.py": {"BAOptions.gradient_tolerance", "BAOptions.pallas_matvec",
                     "BAObservations.img_slot", "BAObservations.pt_slot"},
}


def _bound(tree):
    """Names a module binds at its top level (definitions, assignments,
    imports, also inside ``if`` / ``try``), plus its ``__all__`` when it
    defines a module ``__getattr__``."""
    names, all_ = set(), []
    for node in tree.body:
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    names |= {x.id for x in ast.walk(t)
                              if isinstance(x, ast.Name)}
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        all_ = [e.value for e in n.value.elts]
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0]
                          for a in n.names}
            elif isinstance(n, (ast.If, ast.Try)):
                stack.extend(n.body + n.orelse
                             + getattr(n, "finalbody", [])
                             + [s for h in getattr(n, "handlers", [])
                                for s in h.body])
    if "__getattr__" in names:
        names |= set(all_)
    return names, all_


def _classes(tree):
    """``{class name: (member names, base names)}`` of every class."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            members = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(b.name)
                elif isinstance(b, ast.Assign):
                    members |= {t.id for t in b.targets
                                if isinstance(t, ast.Name)}
                elif isinstance(b, ast.AnnAssign) and \
                        isinstance(b.target, ast.Name):
                    members.add(b.target.id)
            out[node.name] = (members, [ast.unparse(x).split(".")[-1]
                                        for x in node.bases])
    return out


def _gaps():
    """Every JAX public name without a port counterpart, as
    ``(module path, name)``."""
    port_classes = {}
    for f in PORT_PKG.rglob("*.py"):
        for k, v in _classes(ast.parse(f.read_text())).items():
            port_classes.setdefault(k, []).append(v)

    def members(cls, seen):
        if cls in seen:
            return set()
        seen.add(cls)
        out = set()
        for own, bases in port_classes.get(cls, []):
            out |= own
            for b in bases:
                out |= members(b, seen)
        return out

    gaps = set()
    for f in sorted(JAX_PKG.rglob("*.py")):
        rel = f.relative_to(JAX_PKG).as_posix()
        jtree = ast.parse(f.read_text())
        port = PORT_PKG / rel
        if not port.exists():
            gaps.add((rel, None))
            continue
        bound, _ = _bound(ast.parse(port.read_text()))
        jbound, jall = _bound(jtree)
        want = set(jall)
        for node in jtree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                    not node.name.startswith("_"):
                want.add(node.name)
            if rel.endswith("__init__.py") and \
                    isinstance(node, ast.ImportFrom) and node.level >= 1:
                want |= {a.asname or a.name for a in node.names}
        gaps |= {(rel, n) for n in want if n not in bound}
        for cls, (own, _) in _classes(jtree).items():
            if cls.startswith("_"):
                continue
            have = members(cls, set())
            gaps |= {(rel, f"{cls}.{m}") for m in own
                     if not m.startswith("_") and m not in have}
    return gaps


def _roadmap_section3():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### 3. ")
    end = text.find("\n### ", start + 1)
    return text[start:] if end < 0 else text[start:end]


def test_public_surface_matches():
    gaps = _gaps()
    allowed = set()
    for rel, names in DELIBERATE.items():
        if names is None:
            allowed |= {g for g in gaps if g[0] == rel}
        else:
            allowed |= {(rel, n) for n in names}
    missing = sorted(gaps - allowed, key=str)
    assert not missing, f"JAX public names without a port counterpart: " \
                        f"{missing}"
    # each deliberate difference is still one, and ROADMAP.md names it
    section = _roadmap_section3()
    for rel, names in DELIBERATE.items():
        if names is None:
            assert not (PORT_PKG / rel).exists(), rel
            assert rel in section, f"ROADMAP.md: {rel}"
            continue
        for n in names:
            assert (rel, n) in gaps, f"{rel}: {n} is ported now"
            assert n.split(".")[-1] in section, f"ROADMAP.md: {n}"


def test_reexports_import():
    import pixsfm_tpu_torch as P
    from pixsfm_tpu_torch import features, keypoint_adjustment, native, ops
    for name in ("interpolate", "interpolate_with_grad", "interpolate_nodes",
                 "interpolate_nodes_with_grad", "CAMERA_MODELS",
                 "point_in_front", "count_edges_AB", "log_quat",
                 "interpolation_default_conf", "solver_default_conf"):
        assert hasattr(P.base, name), name
    assert features.kDensePatchId == 1_000_000
    assert keypoint_adjustment.TopologicalReferenceKeypointAdjuster
    assert ops.lm_solve and ops.LMOptions and ops.LMSummary
    assert native.available() is True
    assert native.lib is native.load()


def test_set_debug():
    import pixsfm_tpu_torch as P
    levels = P.logger.level, P.handler.level
    try:
        P.set_debug()
        assert P.logger.level == P.handler.level == logging.DEBUG
    finally:
        P.logger.setLevel(levels[0])
        P.handler.setLevel(levels[1])


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q[0] = [1.0, 0.0, 0.0, 0.0]           # the identity: log's small branch
    q[1] = [-0.5, 0.5, 0.5, -0.5]         # negative w
    return q


def test_geometry_matches_jax():
    import jax.numpy as jnp
    from pixsfm_tpu.base import geometry as J
    from pixsfm_tpu_torch.base import geometry as T
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    t = rng.standard_normal((16, 3)).astype(np.float32)
    delta = 0.1 * rng.standard_normal((16, 6)).astype(np.float32)
    delta[0] = 0.0
    tq1, tq2, tt, td = (torch.from_numpy(a) for a in (q1, q2, t, delta))
    jq1, jq2, jt, jd = (jnp.asarray(a) for a in (q1, q2, t, delta))

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)

    close(T.quat_conj(tq1), J.quat_conj(jq1))
    close(T.log_quat(tq1), J.log_quat(jq1))
    for a, b in zip(T.invert_pose(tq1, tt), J.invert_pose(jq1, jt)):
        close(a, b)
    for a, b in zip(T.pose_update(T.quat_normalize(tq1), tt, td),
                    J.pose_update(J.quat_normalize(jq1), jt, jd)):
        close(a, b)
    close(T.angle_between_quats(tq1, tq2), J.angle_between_quats(jq1, jq2))
    # log inverts exp on small tangents
    phi = torch.from_numpy(0.3 * rng.standard_normal((8, 3))
                           .astype(np.float32))
    np.testing.assert_allclose(T.log_quat(T.exp_quat(phi)).numpy(),
                               phi.numpy(), atol=1e-6)


@pytest.mark.parametrize("name,params", [
    ("trivial", []), ("scaled", [0.5]), ("huber", [0.7]),
    ("soft_l1", [0.4]), ("cauchy", [0.25]), ("arctan", [2.0]),
    ("tukey", [1.5])])
def test_functional_losses_match_jax(name, params):
    import jax.numpy as jnp
    from pixsfm_tpu.base import losses as J
    from pixsfm_tpu_torch.base import losses as T
    s = np.linspace(0.0, 4.0, 33).astype(np.float32)
    for tf, jf in ((T.robust_loss, J.robust_loss),
                   (T.loss_weight, J.loss_weight)):
        np.testing.assert_allclose(
            tf(name, torch.from_numpy(s), params).numpy(),
            np.asarray(jf(name, jnp.asarray(s), params)), rtol=1e-6,
            atol=1e-7)


def _graphs():
    from pixsfm_tpu.base.graph import Graph as JGraph
    from pixsfm_tpu_torch.base.graph import Graph as TGraph
    rng = np.random.default_rng(3)
    names = [f"im{i}.jpg" for i in range(5)]
    graphs = JGraph(), TGraph()
    for g in graphs:
        g.add_node("lonely.jpg", 7)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            m = np.stack([rng.choice(30, 12, replace=False),
                          rng.choice(30, 12, replace=False)], -1)
            sims = rng.choice([0.25, 0.5, 1.0], 12)
            for g in graphs:
                g.register_matches(a, b, m, sims)
    return graphs


def test_graph_methods_match_jax():
    from pixsfm_tpu.base import graph as J
    from pixsfm_tpu_torch.base import graph as T
    jg, tg = _graphs()
    assert tg.add_node("lonely.jpg", 7) == jg.add_node("lonely.jpg", 7) == 0
    np.testing.assert_array_equal(tg.get_degrees(), jg.get_degrees())
    np.testing.assert_array_equal(tg.get_scores(), jg.get_scores())
    assert tg.get_edges() == jg.get_edges()
    labels = J.compute_track_labels(jg)
    np.testing.assert_array_equal(T.compute_track_labels(tg), labels)
    roots = J.compute_root_labels(jg, labels,
                                  J.compute_score_labels(jg, labels))
    np.testing.assert_array_equal(T.count_track_edges(tg, labels),
                                  J.count_track_edges(jg, labels))
    np.testing.assert_array_equal(T.count_edges_AB(tg, labels, roots),
                                  J.count_edges_AB(jg, labels, roots))


def test_camera_and_projection_names_match_jax():
    import jax.numpy as jnp
    from pixsfm_tpu.base import cameras as JC
    from pixsfm_tpu.base import projection as JP
    from pixsfm_tpu_torch.base import cameras as TC
    from pixsfm_tpu_torch.base import projection as TP
    for model, params in (("PINHOLE", [800.0, 810.0, 320.0, 240.0]),
                          ("SIMPLE_RADIAL", [900.0, 320.0, 240.0, 0.01]),
                          ("OPENCV", [700.0, 705.0, 1, 2, 0, 0, 0, 0])):
        assert TC.Camera(1, model, 640, 480, params).mean_focal_length == \
            JC.Camera(1, model, 640, 480, params).mean_focal_length
    rng = np.random.default_rng(5)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.1, -0.2, 0.5], np.float32)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    X[0] = 0.0
    want = np.asarray(JP.point_in_front(jnp.asarray(q), jnp.asarray(t),
                                        jnp.asarray(X)))
    got = TP.point_in_front(torch.from_numpy(q), torch.from_numpy(t),
                            torch.from_numpy(X))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < 40
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", ["image", "dsift"])
def test_extractor_names_match_jax(tmp_path, model):
    import PIL.Image
    from pixsfm_tpu.features import extractor as J
    from pixsfm_tpu_torch.features import extractor as T
    assert {k: int(v) for k, v in J.RESIZE_FILTERS.items()} == \
        T.RESIZE_FILTERS
    rng = np.random.default_rng(7)
    fmap = rng.standard_normal((20, 24, 5)).astype(np.float32)
    corners = rng.integers(0, 12, (9, 2))
    np.testing.assert_array_equal(T.extract_patches_numpy(fmap, corners, 8),
                                  J.extract_patches_numpy(fmap, corners, 8))
    path = tmp_path / "view.png"
    PIL.Image.fromarray(rng.integers(0, 255, (300, 500, 3), np.uint8)).save(
        path)
    for conf in ({"sparse": True, "pyr_scales": [1.0, 0.5]},
                 {"sparse": False, "max_edge": 400, "pyr_scales": [1.0, 0.5],
                  "dtype": "float"}):
        conf = {**conf, "model": {"name": model}}
        jx, tx = J.FeatureExtractor(conf), T.FeatureExtractor(conf,
                                                              device="cpu")
        assert tx.num_levels == jx.num_levels == 2
        assert tx.estimate_req_memory(path, 123) == \
            jx.estimate_req_memory(path, 123)


def test_reference_and_lm_state_match_jax():
    from pixsfm_tpu.bundle_adjustment.references import Reference as JRef
    from pixsfm_tpu.ops.lm import LMState as JState
    from pixsfm_tpu_torch.bundle_adjustment.references import \
        Reference as TRef
    from pixsfm_tpu_torch.ops.lm import LMState as TState
    d = np.zeros(4 * 3, np.float32)
    for obs in (None, [(1, 2), (3, 4)]):
        j, t = JRef((1, 2), d, observations=obs), TRef((1, 2), d,
                                                       observations=obs)
        assert t.channels == j.channels == 12
        assert t.has_observations() == j.has_observations() == \
            (obs is not None)
    assert TState._fields == JState._fields and len(TState._fields) == 12


def test_hloc_writers_round_trip_both_ways(tmp_path):
    pytest.importorskip("h5py")
    from pixsfm_tpu.util import hloc as J
    from pixsfm_tpu_torch.util import hloc as T
    rng = np.random.default_rng(11)
    pairs = [("a.jpg", "b.jpg"), ("a.jpg", "c.jpg"), ("b.jpg", "c.jpg")]
    matches = [np.stack([rng.choice(40, 15, replace=False),
                         rng.choice(40, 15, replace=False)], -1)
               for _ in pairs]
    scores = [rng.uniform(0, 1, 15).astype(np.float32), np.zeros(0),
              rng.uniform(0, 1, 15).astype(np.float32)]
    for writer, reader in ((T, J), (J, T)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        writer.write_image_pairs(d / "pairs.txt", pairs)
        assert reader.read_image_pairs(d / "pairs.txt") == pairs
        assert (d / "pairs.txt").read_text() == \
            "a.jpg b.jpg\na.jpg c.jpg\nb.jpg c.jpg"
        writer.write_matches_hloc(d / "m.h5", pairs, matches, scores)
        got_m, got_s = reader.read_matches_hloc(d / "m.h5", pairs)
        for k, (m, s) in enumerate(zip(matches, scores)):
            order = np.argsort(m[:, 0])
            np.testing.assert_array_equal(got_m[k], m[order])
            np.testing.assert_array_equal(
                got_s[k], s[order] if len(s) else np.ones(len(m)))
    assert (tmp_path / "pixsfm_tpu_torch" / "m.h5").read_bytes() != b""


def test_config_names_match_jax(monkeypatch):
    from pixsfm_tpu import config as J
    from pixsfm_tpu_torch import config as T
    assert repr(T.MISSING) == repr(J.MISSING) == "???"
    d = {"a": {"b": 1, "c": [1, 2]}, "d": "${a.b}"}
    text = "a:\n  b: 3\nd: x\n"
    for src in (d, text, None):
        assert T.OmegaConf.create(src).to_dict() == \
            J.OmegaConf.create(src).to_dict()
    tc, jc = T.OmegaConf.create(d), J.OmegaConf.create(d)
    copy = T.OmegaConf.create(tc)
    copy.a.b = 5
    assert tc.a.b == 1 and copy.d == 5
    assert T.OmegaConf.merge(tc, {"a": {"b": 2}}).to_dict() == \
        J.OmegaConf.merge(jc, {"a": {"b": 2}}).to_dict()
    for resolve in (True, False):
        assert T.OmegaConf.to_container(tc, resolve=resolve) == \
            J.OmegaConf.to_container(jc, resolve=resolve)
    assert T.OmegaConf.to_container(3) == J.OmegaConf.to_container(3) == 3
    argv = ["prog", "a.b=4", "--flag", "e.f=[1, 2]", "g=true"]
    dotlist = [a for a in argv if "=" in a]
    assert T.OmegaConf.from_cli(dotlist).to_dict() == \
        J.OmegaConf.from_cli(dotlist).to_dict()
    monkeypatch.setattr("sys.argv", argv)
    assert T.OmegaConf.from_cli().to_dict() == \
        J.OmegaConf.from_cli().to_dict() == \
        {"a": {"b": 4}, "e": {"f": [1, 2]}, "g": True}
    for fn in ("set_struct", "set_readonly"):
        assert getattr(T.OmegaConf, fn)(tc, True) is None
        assert getattr(J.OmegaConf, fn)(jc, True) is None


def test_add_common_args_parses_as_jax():
    from pixsfm_tpu.refine_colmap import add_common_args as jadd
    from pixsfm_tpu_torch.refine_colmap import add_common_args as tadd
    argv = ["--image_dir", "imgs", "--config_path", "default",
            "--cache_path", "c.h5", "a.b=1", "x.y=z"]
    parsed = []
    for add in (tadd, jadd):
        p = argparse.ArgumentParser()
        add(p)
        parsed.append(vars(p.parse_args(argv)))
    assert parsed[0] == parsed[1] == {
        "image_dir": Path("imgs"), "config_path": "default",
        "cache_path": Path("c.h5"), "dotlist": ["a.b=1", "x.y=z"]}

"""A traced run reads the program's own spans and counters: the four
metrics that read them are reported and the traced job's idle gaps are
named by the program's spans; a run with tracing off reports none of them
and the program records nothing."""

import json

from portbench.tests import tiny

NEW = ("ba_setup_s.map", "ba_lm_s.map", "ba_lm_idle.map", "ba_syncs.map")


def _root(tmp_path):
    """The tiny cell, added to the new metrics' cells."""
    root = tiny.tiny_root(tmp_path, {"tiny_plane.ba":
                                     tiny.CELLS["tiny_plane.ba"]})
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny_plane.ba")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_traced_run_reads_the_program_spans(tmp_path):
    from pixsfm_tpu_torch.util import profiling
    root = _root(tmp_path)
    profiling.clear_recorded()
    r = tiny.run(root, "tiny_plane.ba", trace=1)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    rec = profiling.recorded()
    names = {s.name for s in rec.spans}
    assert {"run_ba", "extract", "extract.project", "ba", "ba.level",
            "ba.pack", "ba.references", "ba.layout", "ba.lm",
            "ba.lm.iter", "ba.unpack"} <= names
    assert len({s.job for s in rec.spans}) == 1        # the traced job
    assert 0 < m["ba_setup_s.map"] and 0 < m["ba_lm_s.map"]
    assert m["ba_lm_s.map"] == rec.seconds("ba.lm")
    assert m["ba_lm_idle.map"] == 100.0     # no device operation on a CPU
    assert m["ba_syncs.map"] == sum(
        rec.counts("sync.", within="ba").values()) > 0
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps and all(name in names for name, _ in gaps)


def test_untraced_run_records_nothing(tmp_path):
    from pixsfm_tpu_torch.util import profiling
    root = _root(tmp_path)
    profiling.clear_recorded()
    r = tiny.run(root, "tiny_plane.ba", trace=0)
    assert not set(NEW) & set(r["metrics"])
    assert profiling.recorded().spans == []
    assert profiling.recorded().counters == {}

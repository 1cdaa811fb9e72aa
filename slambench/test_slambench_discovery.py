"""Discovery by name: a cell is found from BENCHMARK.json, its
configuration, traffic, metric readers and spans from files of their own;
a cell, a traffic mix and a metric added as new files run without an edit
to any file that is there."""

import hashlib
import json
import os
import shutil

import pytest

from slambench import testing
from slambench.lib import spec
from textslam_tpu_torch.config import _parse_filestorage

ROOT = testing.ROOT


def test_every_cell_finds_its_files():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"], ROOT)
        assert c["config"]["name"] == w["config"]
        names = {m["name"] for m in c["end_to_end"]}
        assert {"setup_s", "frames_per_s"} <= names
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))
        text_only = {"text_maturation_ms", "sampler_roofline_pct"}
        has = {m["name"] for m in c["per_layer"]}
        assert (text_only <= has) == (not c["config"]["overrides"].get("no_text", False))
    with pytest.raises(KeyError):
        spec.cell(bench, "no.such_cell", ROOT)


def test_config_files_match_benchmark_entries():
    bench = spec.load_benchmark(ROOT)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        # the yaml the configuration names is the one it pins and records
        path = os.path.join(ROOT, cfg["yaml_file"])
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == cfg["yaml_sha256"]
        assert _parse_filestorage(path) == cfg["yaml"]
        assert set(cfg["limits"]) >= {"stages_empty", "pose_gap", "orb_mismatch_pct"}


def test_spans_resolve_against_the_system():
    from slambench.lib import probe

    class Slam:  # the attribute paths the span files name, text off
        class tracker:
            text_frontend = None
            process = _insert_keyframe = staticmethod(lambda *a: None)
        loop_closer = type("L", (), {"run": staticmethod(lambda *a: None)})
        track_monocular = staticmethod(lambda *a: None)

    per_layer = spec.load_benchmark(ROOT)["per_layer"]
    found = {s["name"]: probe.resolve(s, Slam) for s in spec.spans(per_layer)}
    assert found["text.dispatch_immature"] is None  # no text frontend: skipped
    assert found["tracking.process"][1] == "process"
    assert found["frame.build_frame"][0].__name__ == "textslam_tpu_torch.system"


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark plus a configuration, a traffic mix and a
    per-layer metric, each a new file, and the entries naming them."""
    bench_dir = tmp_path / "slambench"
    shutil.copytree(testing.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    with open(bench_dir / "configs" / "general_motion_notext.json", encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["name"] = "outdoor_notext"
    (bench_dir / "configs" / "outdoor_notext.json").write_text(json.dumps(cfg))
    with open(bench_dir / "traffic" / "walk.json", encoding="utf-8") as f:
        traffic = json.load(f)
    traffic["boxes_per_segment"] = 1
    (bench_dir / "traffic" / "sparse.json").write_text(json.dumps(traffic))
    (bench_dir / "spans" / "tracking.check_new_keyframe.json").write_text(json.dumps(
        {"root": "slam", "path": "tracker", "attr": "_check_new_keyframe"}))
    (bench_dir / "metrics" / "window_frames.py").write_text(
        "SPANS = ('tracking.check_new_keyframe',)\n\n\ndef read(ctx):\n"
        "    n = sum(1 for s in ctx['spans'] if s[0] == 'tracking.check_new_keyframe')\n"
        "    return float(ctx['attempted']) if n else None\n")
    bench["configs"].append({"name": "outdoor_notext", "source": "test", "reduced": [],
                             "file": "slambench/configs/outdoor_notext.json", "why": "test"})
    bench["workloads"].append({"name": "outdoor.sparse", "config": "outdoor_notext",
                               "traffic": "sparse", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "window_frames", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "system", "moves": "frames_per_s",
                               "workloads": ["outdoor.sparse"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = testing.tiny_run("outdoor.sparse", trace=1, root=str(tmp_path), bench_dir=str(bench_dir))
    assert res["metrics"]["window_frames"]["value"] == res["attempted"] > 0
    assert "text_maturation_ms" not in res["metrics"]  # text-only metric, text off
    assert {"frame_ms_p50", "track_ms", "frame_build_ms"} <= set(res["metrics"])
    assert res["numbers"]["hamming_calls"] > 0 and res["numbers"]["orb_mismatch_pct"] == 0.0
    # the new span is installed for the metric that names it, in its own cell only
    new_cell = spec.cell(json.loads((tmp_path / "BENCHMARK.json").read_text()), "outdoor.sparse",
                         str(tmp_path), str(bench_dir))
    old_cell = spec.cell(json.loads((tmp_path / "BENCHMARK.json").read_text()), "gm_notext.walk",
                         str(tmp_path), str(bench_dir))
    assert "tracking.check_new_keyframe" in {s["name"] for s in spec.spans(
        new_cell["per_layer"], str(bench_dir))}
    assert "tracking.check_new_keyframe" not in {s["name"] for s in spec.spans(
        old_cell["per_layer"], str(bench_dir))}

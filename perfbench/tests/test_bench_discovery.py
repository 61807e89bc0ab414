"""A configuration, a traffic mix and a per-layer metric are found by name:
adding files and entries reaches them with no existing file edited."""
import json
import shutil

from perfbench import harness
from perfbench.tests.tiny import ROOT


def _checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_are_found_without_edits(tmp_path):
    root = _checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "perfbench/configs/speech_nollm.json").read_text())
    cfg["name"] = "speech_nollm_b"
    (root / "perfbench/configs/speech_nollm_b.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/corpus_mixed16.json").read_text())
    mix["batch"] = 8
    (root / "perfbench/traffic/corpus_mixed8.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/steps_seen.synth.py").write_text(
        "def read(layer):\n    return None if layer is None else float(layer['batches'])\n")
    (root / "perfbench/limits/nollm_synth_b8.json").write_text('{"mel_gap": 1.0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "speech_nollm_b", "source": "x", "reduced": [], "why": "x",
                             "file": "perfbench/configs/speech_nollm_b.json"})
    bench["workloads"].append({"name": "nollm_synth_b8", "config": "speech_nollm_b",
                               "traffic": "corpus_mixed8", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("synth_"):
            m["workloads"].append("nollm_synth_b8")
    bench["per_layer"].append({"name": "steps_seen.synth", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "synth_audio_s_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data
    bench = harness.benchmark(root)
    cell = harness.cell_of(bench, "nollm_synth_b8")
    assert harness.config_of(bench, root, cell["config"])["name"] == "speech_nollm_b"
    mix = harness.mix_of(root, cell["traffic"])
    assert mix["batch"] == 8 and harness.runner_of(mix).__name__ == "perfbench.runners.synth"
    assert harness.limits_of(root, "nollm_synth_b8") == {"mel_gap": 1.0}
    layer = [m["name"] for m in harness.cell_metrics(bench, "nollm_synth_b8", "per_layer")]
    assert "steps_seen.synth" in layer and "encoder_ms.synth" not in layer
    # a metric without ``workloads`` reaches every cell that reports what it moves
    assert "steps_seen.synth" in [m["name"] for m in
                                  harness.cell_metrics(bench, "e2e_synth_mixed", "per_layer")]
    assert "steps_seen.synth" not in [m["name"] for m in
                                      harness.cell_metrics(bench, "nollm_train", "per_layer")]
    assert harness.reader(root, "steps_seen.synth")({"batches": 3}) == 3.0
    assert harness.reader(root, "steps_seen.synth")(None) is None


def test_every_named_file_is_there():
    bench = harness.benchmark(ROOT)
    for w in bench["workloads"]:
        harness.config_of(bench, ROOT, w["config"])
        harness.runner_of(harness.mix_of(ROOT, w["traffic"]))
        harness.limits_of(ROOT, w["name"])
    for m in bench["per_layer"]:
        assert harness.reader(ROOT, m["name"])(None) is None

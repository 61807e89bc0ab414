"""BENCHMARK.json and the result line against the benchmark's contract; a run
with no card, and a checkout without the program, print no result."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_files(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith(("_roofline", "mfu"))


@pytest.mark.parametrize("cell", ["nollm_train", "e2e_synth_mixed", "nollm_synth_mixed"])
def test_each_cell_reports_setup_another_and_a_layer(bench, cell):
    e2e = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    layer = harness.cell_metrics(bench, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def _fake_outcome():
    return harness.Outcome(
        values={"setup_s": 30.5, "train_audio_s_per_s": 45.25, "peak_gib": 23.0},
        layer=None, compared={"loss_gap": 0.001, "grad_gap": 0.02, "change_gap": 0.003},
        attempted=70, failed=0, peak_bytes=24 * 2 ** 30,
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})


def test_result_line(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    class Fake:
        @staticmethod
        def run(ctx):
            return _fake_outcome()

    monkeypatch.setattr(harness, "runner_of", lambda mix: Fake)
    rc = harness.main(["--workload", "nollm_train", "--seed", str(2 ** 33 + 1), "--seconds", "1",
                       "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["train_audio_s_per_s"] == {"value": 45.25, "unit": "audio-s/s"}
    assert set(line["metrics"]) == {"setup_s", "train_audio_s_per_s", "peak_gib"}
    assert line["device"]["memory_peak_bytes"] == 24 * 2 ** 30
    limits = harness.limits_of(ROOT, "nollm_train")
    assert line["correct"] == all(v <= limits[k] for k, v in _fake_outcome().compared.items())
    tail = err.strip().splitlines()[-3:]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nollm_train",
                           "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nollm_train",
                           "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["nollm_train", "e2e_synth_mixed"])
def test_a_card_but_no_program_no_result(monkeypatch, capsys, cell):
    """Past the look for a card, a checkout without the port fails before
    any result: the runner's import of the program raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name in list(sys.modules):
        if name.split(".")[0] == "multimodalvc_tpu_torch":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "multimodalvc_tpu_torch", None)
    with pytest.raises(ImportError):
        harness.main(["--workload", cell, "--seed", "7", "--seconds", "1", "--trace", "0"])
    assert capsys.readouterr().out.strip() == ""

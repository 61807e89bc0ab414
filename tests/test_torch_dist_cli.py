"""The port's ``cli.train`` on two gloo ranks (tests/torch_dist_worker.py)
over the tiny AVSR preset and the synthetic corpus of tests/fixtures.py,
without dropout: each rank takes its share of every epoch's batches, both
log the same losses (the batch group's), rank 0 alone writes the
checkpoints, the checkpoint resumes in one process, and the run leaves no
mesh behind for a later training in the same ranks."""
import numpy as np
import pytest
from torch_dist_worker import nollm_batch, spawn
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu_torch.cli import train as ttrain
from multimodalvc_tpu_torch.data.batching import shard_batches
from multimodalvc_tpu_torch.models import avsr as tavsr

from tests.fixtures import make_corpus

UPDATES = 3
NOLLM = dict(opt=dict(lr=1e-3, warmup_updates=2, max_update=10, adam_eps=1e-3), steps=2)


def model_stats(stats):
    """The model's numbers of logged stats (not the host's timings)."""
    return [{k: v for k, v in s.items() if k not in ("data_ms", "step_ms", "ups")}
            for s in stats]


def argv(root, noise, save_dir, max_update):
    return ["common.log_interval=1", "common.compute_dtype=float32", "mesh.data=-1",
            f"dataset.data={root}", "dataset.max_tokens=64", "dataset.num_workers=0",
            "dataset.required_batch_size_multiple=1", "dataset.valid_wer_batches=1",
            f"optimization.max_update={max_update}", "optimization.lr=1e-3",
            "optimization.warmup_updates=2", "optimization.adam_eps=1e-5",
            f"checkpoint.save_dir={save_dir}", "generation.beam=2", "generation.max_len=6",
            "task.name=avsr_training", f"task.noise_wav={noise}", "task.noise_prob=0.5",
            "task.max_video_frames=16", "task.max_label_tokens=16", "task.length_buckets=[16]",
            "model.name=mms_llama_avsr", "model.preset=tiny"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distcli")
    root, noise = make_corpus(str(tmp / "corpus"), frame_sizes=(10, 14, 16))
    save = tmp / "ckpt"
    np.savez(tmp / "nollm.npz", **nollm_batch())
    nollm = dict(NOLLM, batch=str(tmp / "nollm.npz"))
    ranks = spawn(tmp, 2, [("nollm_one:before", nollm),
                           ("cli_train", dict(argv=argv(root, noise, save, UPDATES))),
                           ("nollm_one:after", nollm)])
    return dict(ranks=[r["cli_train"] for r in ranks], root=root, noise=noise, save=save,
                nollm=[(r["nollm_one:before"], r["nollm_one:after"]) for r in ranks])


def test_two_ranks_log_the_same_losses(run):
    a, b = run["ranks"]
    assert [s for s, _ in a["train"]] == list(range(1, UPDATES + 1))
    assert model_stats(s for _, s in a["train"]) == model_stats(s for _, s in b["train"])
    assert all(np.isfinite(s["loss"]) for _, s in a["train"])
    # every rank validates the whole set; no beam WER in a launch of two
    assert model_stats(a["valid"]) == model_stats(b["valid"]) and a["valid"]
    assert all("wer" not in v for v in a["valid"])


def test_a_finished_run_leaves_no_mesh_behind(run):
    """cli.train's {data: 2} mesh is current only while it runs: the NoLLM
    steps that the same ranks run after it, with no mesh of their own, are
    bit for bit the steps they ran before it.  (A mesh left current would be
    taken by the later Trainer: rank 1's dropout stream apart, the losses
    over twice the rows, the gradients summed over both ranks.)"""
    for before, after in run["nollm"]:
        assert len(before) == NOLLM["steps"] and all(np.isfinite(m["loss"]) for m in before)
        assert after == before


def test_each_rank_takes_its_share_of_the_batches():
    batches = [np.arange(i, i + 2) for i in range(5)]
    shares = [shard_batches(batches, 2, r) for r in range(2)]
    assert [len(s) for s in shares] == [3, 3]
    assert [b[0] for b in shares[0]] == [0, 2, 4] and [b[0] for b in shares[1]] == [1, 3, 0]


def test_rank_0_alone_writes_the_checkpoint(run):
    a, b = run["ranks"]
    assert "checkpoint_last" in a["writes"] and b["writes"] == []
    assert (run["save"] / "checkpoint_last" / "state.pt").exists()
    assert (run["save"] / "meta.json").exists()


def test_the_checkpoint_resumes_on_one_rank(run, monkeypatch):
    monkeypatch.setattr(tavsr, "train_rng", lambda train, generator: None)
    lines = []
    real = ttrain.log_stats
    monkeypatch.setattr(ttrain, "log_stats", lambda stats, step, prefix="train", fmt="simple": (
        lines.append((prefix, step, dict(stats))), real(stats, step, prefix, fmt)))
    cfg, _ = ttrain.parse_args(argv(run["root"], run["noise"], run["save"], UPDATES + 1))
    ttrain.main(cfg, device="cpu")
    steps = [step for p, step, _ in lines if p == "train"]
    assert steps == [UPDATES + 1]

"""The pretraining-label pipeline against the JAX package's: MFCCs bit for
bit, mini-batch k-means (the same numpy init and permutations; centroids to
1e-5 and labels equal), the centroid and feature files read across the
packages, and ``cli.manifest_tools``' dump-features / learn-kmeans /
dump-labels run by both packages on the same corpus: the same centroids,
``.km`` files and feature dumps (the port's from a port checkpoint, the
JAX one's from the same weights in a JAX checkpoint)."""
import argparse

import jax
import numpy as np
import pytest
import torch
from torch_parity import to_numpy_tree  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu.cli import manifest_tools as jtools
from multimodalvc_tpu.data import audio as jaudio
from multimodalvc_tpu.data import clustering as jclust
from multimodalvc_tpu.models import avhubert_pretrain as jpre
from multimodalvc_tpu.runtime import checkpoint as jckpt
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.cli import manifest_tools as ttools
from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.data import clustering as tclust
from multimodalvc_tpu_torch.interop.from_flax import state_dict_to_flax_variables
from multimodalvc_tpu_torch.models import avhubert_pretrain as tpre
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager
from multimodalvc_tpu_torch.runtime.trainer import Trainer

from tests.fixtures import make_corpus

# centroids: running means of f32 features summed in another order than
# XLA's (a few ulps of O(10) MFCC values a step); features through the tiny
# model in f32: test_torch_encoders.py's 1e-4
CENTROID_TOL, FEATURE_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root, _ = make_corpus(str(tmp_path_factory.mktemp("kmcorpus")), n=6, frame_sizes=(20, 33, 41))
    return root


@pytest.mark.parametrize("n", [400, 9999, 32000])
def test_mfcc_bit_for_bit(n):
    wav = (0.3 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    for deltas in (True, False):
        want, got = jclust.mfcc_np(wav, deltas=deltas), tclust.mfcc_np(wav, deltas=deltas)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _blobs(n=900, k=6, d=39, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 4.0
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("n,batch_size", [(900, 128), (50, 128)], ids=["batches", "one_batch"])
def test_minibatch_kmeans_matches_jax(n, batch_size, tmp_path):
    """fit (init and permutations from default_rng(seed); a last partial
    batch dropped, or one batch of every frame when there are fewer than a
    batch) and predict, then the centroid files read across."""
    feats = _blobs(n)
    want = jclust.MiniBatchKMeans(8, batch_size=batch_size, seed=3).fit(feats, epochs=3)
    got = tclust.MiniBatchKMeans(8, batch_size=batch_size, seed=3, device="cpu").fit(feats, 3)
    assert got.centroids.dtype == np.float32 and len(got.epoch_inertia) == 3
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=CENTROID_TOL, atol=CENTROID_TOL)
    probe = _blobs(300, seed=1)
    np.testing.assert_array_equal(got.predict(probe), want.predict(probe))
    assert got.predict(probe).dtype == np.int32
    got.save(str(tmp_path / "port.npy"))
    want.save(str(tmp_path / "jax.npy"))
    np.testing.assert_array_equal(jclust.MiniBatchKMeans.load(str(tmp_path / "port.npy")).predict(
        probe), tclust.MiniBatchKMeans.load(str(tmp_path / "jax.npy"), device="cpu").predict(probe))
    with pytest.raises(RuntimeError, match="fit first"):
        tclust.MiniBatchKMeans(4, device="cpu").predict(probe)


def test_assignment_ties_go_to_the_first_centroid():
    c = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    x = torch.tensor([[2.0, 0.0], [0.5, 0.5], [0.0, 3.0]])
    assert tclust.assign(x, c).tolist() == [0, 0, 2]


def _args(**kw):
    return argparse.Namespace(**kw)


def _checkpoints(root, tmp_path):
    """A port checkpoint of the tiny pretraining model after one update
    (cli.train's state), and a JAX checkpoint of the same weights."""
    task = ttasks.AVHubertPretrainTask(ttasks.AVHubertPretrainTaskConfig(),
                                       tpre.AVHubertPretrainConfig.tiny(), device="cpu")
    task.init_random(4)
    trainer = Trainer(task.make_loss_fn(), task.module, OptimizationConfig(lr=1e-3), [], seed=2)
    rng = np.random.default_rng(1)
    batch = {"audio": torch.from_numpy(rng.standard_normal((2, 20, 104)).astype(np.float32)),
             "video": torch.from_numpy(rng.standard_normal((2, 20, 88, 88, 1)).astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(0, 16, (2, 20)).astype(np.int32)),
             "lengths": torch.tensor([20, 13], dtype=torch.int32)}
    trainer.train_step(batch)
    CheckpointManager(str(tmp_path / "port_ckpt")).save(trainer.state_dict(), trainer.step)
    jm = jpre.AVHubertPretrainModel(jpre.AVHubertPretrainConfig.tiny())
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "mask": k}, batch["audio"].numpy(),
                                              batch["video"].numpy(), batch["targets"].numpy(),
                                              batch["lengths"].numpy(), train=True),
                            jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    v = state_dict_to_flax_variables(task.module.state_dict(), template)
    mgr = jckpt.CheckpointManager(str(tmp_path / "jax_ckpt"), async_save=False)
    mgr.save({"params": v["params"], "collections": {"batch_stats": v["batch_stats"]}}, 1)
    mgr.wait()
    return str(tmp_path / "port_ckpt"), str(tmp_path / "jax_ckpt")


def test_manifest_tools_pipeline_matches_jax(corpus, tmp_path):
    """Iteration 1 (MFCC k-means, labels) and iteration 2 (layer features
    from a checkpoint, k-means on them, labels), each step by both tools;
    every file equal or within tolerance, and each package reads the
    other's."""
    tsv = f"{corpus}/train.tsv"
    out = {side: tmp_path / side for side in ("jax", "port")}
    for d in out.values():
        d.mkdir()
    km_kw = dict(clusters=6, epochs=2, batch_size=256, percent=1.0)
    jtools.cmd_learn_kmeans(_args(tsv=tsv, features=None, out=str(out["jax"] / "km1.npy"), **km_kw))
    ttools.main(["learn-kmeans", "--tsv", tsv, "--clusters", "6", "--epochs", "2",
                 "--batch-size", "256", "--out", str(out["port"] / "km1.npy"), "--device", "cpu"])
    np.testing.assert_allclose(np.load(out["port"] / "km1.npy"), np.load(out["jax"] / "km1.npy"),
                               rtol=CENTROID_TOL, atol=CENTROID_TOL)
    jtools.cmd_dump_labels(_args(tsv=tsv, features=None, centroids=str(out["port"] / "km1.npy"),
                                 out=str(out["jax"] / "train.km")))
    n = ttools.main(["dump-labels", "--tsv", tsv, "--centroids", str(out["jax"] / "km1.npy"),
                     "--out", str(out["port"] / "train.km"), "--device", "cpu"])
    assert n == 6
    assert (out["port"] / "train.km").read_text() == (out["jax"] / "train.km").read_text()
    rows = (out["port"] / "train.km").read_text().splitlines()
    wav_frames = [len(jclust.mfcc_np(jaudio.read_wav(p)))
                  for p in tclust.manifest_audio_paths(tsv)]
    assert [len(r.split()) for r in rows] == wav_frames

    port_ckpt, jax_ckpt = _checkpoints(corpus, tmp_path)
    common = ["--tsv", tsv, "--preset", "tiny", "--layer", "1", "--crop-size", "88"]
    ttools.main(["dump-features", "--ckpt", port_ckpt, "--out", str(out["port"] / "feats"),
                 "--device", "cpu", *common])
    jtools.cmd_dump_features(_args(tsv=tsv, ckpt=jax_ckpt, ckpt_name="checkpoint_last",
                                   model="av_hubert_pretrain", preset="tiny", layer=1,
                                   max_frames=500, crop_size=88, out=str(out["jax"] / "feats")))
    jf, jl = jtools._read_feature_dump(str(out["jax"] / "feats"))
    tf, tl = ttools._read_feature_dump(str(out["port"] / "feats"))
    assert tl == jl and tf.shape == jf.shape == (sum(jl), 64) and tf.dtype == np.float32
    assert float(np.abs(tf - jf).max()) < FEATURE_TOL

    jtools.cmd_learn_kmeans(_args(tsv=None, features=str(out["port"] / "feats"),
                                  out=str(out["jax"] / "km2.npy"), **km_kw))
    ttools.main(["learn-kmeans", "--features", str(out["jax"] / "feats"), "--clusters", "6",
                 "--epochs", "2", "--batch-size", "256", "--out", str(out["port"] / "km2.npy"),
                 "--device", "cpu"])
    np.testing.assert_allclose(np.load(out["port"] / "km2.npy"), np.load(out["jax"] / "km2.npy"),
                               rtol=1e-4, atol=1e-4)
    # each tool labels the other's feature dump with the same centroids
    ttools.main(["dump-labels", "--features", str(out["jax"] / "feats"), "--centroids",
                 str(out["jax"] / "km2.npy"), "--out", str(out["port"] / "train2.km"),
                 "--device", "cpu"])
    jtools.cmd_dump_labels(_args(tsv=None, features=str(out["port"] / "feats"),
                                 centroids=str(out["jax"] / "km2.npy"),
                                 out=str(out["jax"] / "train2.km")))
    labels = [list(map(int, r.split())) for r in
              (out["port"] / "train2.km").read_text().splitlines()]
    assert [len(r) for r in labels] == jl and all(0 <= x < 6 for r in labels for x in r)
    assert (out["port"] / "train2.km").read_text() == (out["jax"] / "train2.km").read_text()


@pytest.mark.parametrize("cmd", ["split", "generate-mels", "make-babble"])
def test_manifest_tools_refuses_the_other_subcommands(cmd, tmp_path):
    """The other subcommands are ported (their outputs against the JAX
    tool's: tests/test_torch_manifest_tools.py): none refuses any more; on
    a missing manifest each fails as the JAX tool's does."""
    import sys
    from unittest import mock

    argv = [cmd, "--tsv", str(tmp_path / "x.tsv")] + {
        "split": ["--out-dir", str(tmp_path)], "generate-mels": [],
        "make-babble": ["--out", str(tmp_path / "b.wav")]}[cmd]
    with pytest.raises(FileNotFoundError) as want, \
            mock.patch.object(sys, "argv", ["manifest_tools", *argv]):
        jtools.main()
    with pytest.raises(FileNotFoundError) as got:
        ttools.main(argv)
    assert str(got.value) == str(want.value)

"""The port's data pipeline against the JAX package's (``data/``, ``ops/audio.py``,
the tasks' ``load_dataset``) on the synthetic corpus of tests/fixtures.py:
manifests, bucketed batches, the host features and the noise mixing bit for
bit, every array of the datasets' samples and collated batches bitwise
(evaluation subsets, and train subsets with noise and crops drawn in the
calling process), and the port's loader in worker processes: the JAX
loader's batches in order, distinct draws in each worker, the same batches
at any worker count >= 1 and after a resume; with 0 workers, a resume draws
as the JAX loader's resume does.  AV-HuBERT's pretraining samples
(``PretrainDataset``: stacked filterbanks, decimated .km labels) bit for
bit too."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.data import audio as jaudio
from multimodalvc_tpu.data import batching as jbatching
from multimodalvc_tpu.data import dataset as jdataset
from multimodalvc_tpu.data import manifest as jmanifest
from multimodalvc_tpu.data import tokenizer as jtok
from multimodalvc_tpu.data import video as jvideo
from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.models import vocoder as jvoc
from multimodalvc_tpu.ops import audio as jops_audio
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.data import audio as taudio
from multimodalvc_tpu_torch.data import batching as tbatching
from multimodalvc_tpu_torch.data import dataset as tdataset
from multimodalvc_tpu_torch.data import manifest as tmanifest
from multimodalvc_tpu_torch.data import tokenizer as ttok
from multimodalvc_tpu_torch.data import video as tvideo
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.ops import audio as tops_audio

from tests.fixtures import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("datacorpus")), n=8,
                       frame_sizes=(12, 30, 45, 60))


def same_arrays(want: dict, got: dict, what: str = "") -> None:
    """The same keys, and each array the same dtype, shape and bits."""
    assert set(want) == set(got), what
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, (what, k, w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


# ---- manifests, tokenizers, batches ------------------------------------------


@pytest.mark.parametrize("limits", [(None, None), (50, None), (None, 20), (45, 20)])
def test_load_manifest_matches_jax(corpus, limits):
    root, _ = corpus
    kw = dict(max_keep_frames=limits[0], min_keep_frames=limits[1],
              label_path=f"{root}/train.wrd")
    want = jmanifest.load_manifest(f"{root}/train.tsv", **kw)
    got = tmanifest.load_manifest(f"{root}/train.tsv", **kw)
    assert got.root == want.root and got.labels == want.labels and len(got) == len(want)
    assert [dataclasses.asdict(e) for e in got.entries] == \
        [dataclasses.asdict(e) for e in want.entries]
    assert got.sizes() == want.sizes()
    for path in ("data/a.npy", "/abs/b.npy"):
        assert tmanifest.resolve_path(root, path) == jmanifest.resolve_path(root, path)


def test_tokenizers_match_jax(tmp_path):
    text = "hello wörld, speech"
    jt, pt = jtok.CharTokenizer(), ttok.CharTokenizer()
    assert pt.encode(text) == jt.encode(text) and pt.encode(text, add_bos=False) == \
        jt.encode(text, add_bos=False)
    ids = pt.encode(text) + [pt.eos_token_id]
    assert pt.decode(ids) == jt.decode(ids) == text
    assert (pt.bos_token_id, pt.eos_token_id, pt.pad_token_id, pt.vocab_size) == \
        (jt.bos_token_id, jt.eos_token_id, jt.pad_token_id, jt.vocab_size)
    assert ttok.INSTRUCTION_TEXT == jtok.INSTRUCTION_TEXT
    # a path that does not load falls back to the byte tokenizer, as in JAX
    for path in (None, str(tmp_path / "missing-llm")):
        assert isinstance(ttok.load_tokenizer(path), ttok.CharTokenizer)


BATCH_CASES = {
    "tokens": dict(max_tokens=120),
    "tokens_multiple": dict(max_tokens=200, required_multiple=4),
    "batch_size": dict(batch_size=3),
    "batch_size_multiple_shuffled": dict(batch_size=7, required_multiple=2, shuffle_seed=3),
    "both_shuffled": dict(max_tokens=300, batch_size=5, shuffle_seed=11),
    "multiple_8": dict(max_tokens=1000, required_multiple=8),
    "one_bucket": dict(max_tokens=64, buckets=(16,)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_by_size_matches_jax(case):
    sizes = np.random.default_rng(5).integers(5, 520, 97)
    kw = BATCH_CASES[case]
    want = jbatching.batch_by_size(sizes, **kw)
    got = tbatching.batch_by_size(sizes, **kw)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(sizes)))  # none dropped
    for length in (1, 100, 101, 500, 900):
        assert tbatching.bucket_for(length, (100, 200, 300, 400, 500)) == \
            jbatching.bucket_for(length, (100, 200, 300, 400, 500))


def test_pad_helpers_match_jax():
    rng = np.random.default_rng(2)
    batch = {"a": rng.standard_normal((5, 3)), "b": np.arange(5), "c": np.ones((2,)),
             "s": np.asarray(1.0)}
    same_arrays(jbatching.pad_batch_to_multiple(batch, 4),
                tbatching.pad_batch_to_multiple(batch, 4))
    x = rng.standard_normal((7, 4)).astype(np.float32)
    for length in (3, 7, 11):
        np.testing.assert_array_equal(tbatching.pad_to(x, length, value=2),
                                      jbatching.pad_to(x, length, value=2))


# ---- host features --------------------------------------------------------------


@pytest.mark.parametrize("n", [400, 12345, 48000])
def test_features_bit_for_bit(n):
    wav = (0.3 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    for name in ("whisper_features_np", "whisper_features_long_np", "hifigan_mel_np",
                 "stacked_logfbank_np"):
        w, g = getattr(jaudio, name)(wav), getattr(taudio, name)(wav)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_noise_mixing_bit_for_bit(corpus):
    _, noise_path = corpus
    rng = np.random.default_rng(0)
    speech = (0.1 * rng.standard_normal((2, 3000))).astype(np.float32)
    noise = (0.05 * rng.standard_normal((2, 3000))).astype(np.float32)
    for snr in (-5.0, 0.0, 12.5, 20.0):
        want = jops_audio.add_noise_snr(speech, noise, snr)
        got = tops_audio.add_noise_snr(speech, noise, snr)
        np.testing.assert_array_equal(got, want)
        # torch tensors: the same formula (f32 sums in torch's order)
        got_t = tops_audio.add_noise_snr(torch.from_numpy(speech), torch.from_numpy(noise), snr)
        np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6, atol=1e-7)
    pcm = (rng.standard_normal(50) * 8000).astype(np.int16)
    np.testing.assert_array_equal(tops_audio.pcm16_to_float(pcm), jops_audio.pcm16_to_float(pcm))
    assert tops_audio.SNR_LEVELS == jops_audio.SNR_LEVELS
    # the mixer: the same segments and SNRs from the same seed
    jm, tm = jaudio.NoiseMixer(noise_path, seed=4), taudio.NoiseMixer(noise_path, seed=4)
    wav = (0.1 * rng.standard_normal(20000)).astype(np.float32)
    for snr in (None, None, 5.0, None):
        np.testing.assert_array_equal(tm(wav, snr), jm(wav, snr))
    np.testing.assert_array_equal(taudio.read_wav(noise_path), jaudio.read_wav(noise_path))


def test_video_transforms_bit_for_bit(corpus):
    root, _ = corpus
    frames = tvideo.load_video_frames(f"{root}/data/clip1.npy")
    np.testing.assert_array_equal(frames, jvideo.load_video_frames(f"{root}/data/clip1.npy"))
    for train in (False, True):
        want = jvideo.transform_video(frames, crop_size=40, train=train,
                                      rng=np.random.default_rng(3))
        got = tvideo.transform_video(frames, crop_size=40, train=train,
                                     rng=np.random.default_rng(3))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---- the tasks' datasets ----------------------------------------------------------


def _task_pair(kind: str, root: str, noise: str):
    """(JAX task, port task) of one ``load_dataset`` flavour at a tiny size."""
    if kind == "avsr":
        kw = dict(data=root, noise_wav=noise, noise_prob=0.6, max_video_frames=60,
                  max_label_tokens=24, length_buckets=(16, 32, 64), image_aug=True)
        return (jtasks.AVSRTask(jtasks.AVSRTaskConfig(**kw), javsr.AVSRConfig.tiny()),
                ttasks.AVSRTask(ttasks.AVSRTaskConfig(**kw), tavsr.AVSRConfig.tiny(),
                                device="cpu"))
    if kind in ("speech_nollm", "speech_llm"):
        kw = dict(data=root, variant=kind.split("_")[1], max_video_frames=60,
                  length_buckets=(32, 64), max_mel_frames=180)
        return (jtasks.SpeechTask(jtasks.SpeechTaskConfig(**kw), jsp.SpeechConfig.tiny()),
                ttasks.SpeechTask(ttasks.SpeechTaskConfig(**kw), tsp.SpeechConfig.tiny(),
                                  device="cpu"))
    if kind == "e2e":
        kw = dict(data=root, max_video_frames=60, length_buckets=(64,), max_mel_frames=150,
                  vocoder_initial_channels=16, vocoder_resblock_kernels=(3,))
        return (jtasks.E2EGanTask(jtasks.E2EGanTaskConfig(**kw), jsp.SpeechConfig.tiny()),
                ttasks.E2EGanTask(ttasks.E2EGanTaskConfig(**kw), tsp.SpeechConfig.tiny(),
                                  device="cpu"))
    gen = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilations=((1, 3, 5),))
    jcfg = jvoc.VocoderConfig(generator=dataclasses.replace(jvoc.VocoderConfig().generator,
                                                            **gen), segment_length=1600)
    tcfg = tvoc.VocoderConfig(generator=dataclasses.replace(tvoc.VocoderConfig().generator,
                                                            **gen), segment_length=1600)
    return (jtasks.VocoderTask(jtasks.VocoderTaskConfig(data=root, segment_length=1600), jcfg),
            ttasks.VocoderTask(ttasks.VocoderTaskConfig(data=root, segment_length=1600), tcfg,
                               device="cpu"))


KINDS = ["avsr", "speech_nollm", "speech_llm", "e2e", "vocoder"]


@pytest.mark.parametrize("subset", ["valid", "train"])
@pytest.mark.parametrize("kind", KINDS)
def test_dataset_items_and_batches_match_jax(corpus, kind, subset):
    """Every sample and collated batch bitwise, in the JAX dataset's order of
    draws (the train subset: noise and crops from the dataset's generators in
    this process); the AVSR task's eos and pad ids follow the tokenizer."""
    root, noise = corpus
    jtask, ttask = _task_pair(kind, root, noise)
    jds, tds = jtask.load_dataset(subset), ttask.load_dataset(subset)
    assert len(tds) == len(jds) and tds.sizes() == jds.sizes()
    np.testing.assert_array_equal(tds.instruction, jds.instruction)
    if kind == "avsr":
        assert (ttask.model_cfg.eos_token_id, ttask.model_cfg.pad_token_id) == \
            (jtask.model_cfg.eos_token_id, jtask.model_cfg.pad_token_id) == (257, 258)
        assert ttask.system.cfg is ttask.model_cfg
    for i in range(len(tds)):
        same_arrays(jds[i], tds[i], f"{kind} {subset} item {i}")
    batches = tds.batches(max_tokens=130, epoch=1)
    for w, g in zip(jds.batches(max_tokens=130, epoch=1), batches):
        np.testing.assert_array_equal(g, w)
    for idx in batches:
        same_arrays(jds.collate([jds[int(i)] for i in idx]), tds.load_batch(idx),
                    f"{kind} {subset} batch {idx}")
    # the port's loader in this process: the same draws, numpy -> tensors
    jloader = jdataset.PrefetchLoader(jds, batches, num_workers=1)
    for w, g in zip(jloader, tdataset.BatchLoader(tds, batches, num_workers=0)):
        same_arrays(w, g, f"{kind} {subset} loader")


def test_loader_workers_match_jax_loader(corpus):
    """Two worker processes yield exactly the JAX PrefetchLoader's batches of
    the valid subset, in order, as CPU tensors."""
    root, noise = corpus
    jtask, ttask = _task_pair("avsr", root, noise)
    jds, tds = jtask.load_dataset("valid"), ttask.load_dataset("valid")
    batches = tds.batches(max_tokens=100)
    assert len(batches) >= 3
    want = list(jdataset.PrefetchLoader(jds, batches, num_workers=2))
    got = list(tdataset.BatchLoader(tds, batches, num_workers=2))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        same_arrays(w, g, "valid loader")


def test_loader_workers_draw_their_own_augmentation(corpus):
    """With noise and crops on, each batch is drawn from generators seeded by
    (seed, epoch, its position in the epoch): the workers draw distinct crops
    and SNRs, and the batches are the same at any worker count >= 1 and after a
    resume that skips the first ones."""
    root, noise = corpus
    _, ttask = _task_pair("avsr", root, noise)
    tds = ttask.load_dataset("train")
    batches = [np.asarray([0, 1])] * 4  # the same clips four times
    two = list(tdataset.BatchLoader(tds, batches, num_workers=2, epoch=3))
    for a in range(4):
        for b in range(a + 1, 4):
            assert not torch.equal(two[a]["video"], two[b]["video"]), (a, b)
    # noise goes on a clip with probability 0.6: not on every batch alike
    assert any(not torch.equal(two[0]["audio_feats"], x["audio_feats"]) for x in two[1:])
    one = list(tdataset.BatchLoader(tds, batches, num_workers=1, epoch=3))
    resumed = list(tdataset.BatchLoader(tds, batches[2:], num_workers=2, epoch=3, first=2))
    for x, y in zip(one, two):
        same_arrays({k: v.numpy() for k, v in x.items()}, y, "one vs two workers")
    for x, y in zip(two[2:], resumed):
        same_arrays({k: v.numpy() for k, v in x.items()}, y, "resumed")
    other_epoch = list(tdataset.BatchLoader(tds, batches[:1], num_workers=1, epoch=4))
    assert not torch.equal(other_epoch[0]["video"], two[0]["video"])
    # the evaluation subset draws nothing: the crops are the center ones
    vds = ttask.load_dataset("valid")
    x, y = tdataset.BatchLoader(vds, [np.asarray([0, 1])] * 2, num_workers=2)
    assert torch.equal(x["video"], y["video"]) and torch.equal(x["audio_feats"],
                                                               y["audio_feats"])


def test_zero_worker_resume_draws_as_the_jax_resume(corpus):
    """With 0 workers a mid-epoch resume draws the remaining batches'
    augmentation from a fresh generator, as the JAX CLI's resume (which
    skips the consumed batches of a new loader) does: bit for bit the JAX
    loader's batches over the same remaining batch list.  Their clips are
    the straight run's, their crops are not."""
    root, noise = corpus
    jtask, ttask = _task_pair("avsr", root, noise)
    batches = [np.asarray([0, 1])] * 4
    straight = list(tdataset.BatchLoader(ttask.load_dataset("train"), batches, num_workers=0,
                                         epoch=3))
    resumed = list(tdataset.BatchLoader(ttask.load_dataset("train"), batches[2:],
                                        num_workers=0, epoch=3, first=2))
    want = list(jdataset.PrefetchLoader(jtask.load_dataset("train"), batches[2:],
                                        num_workers=1))
    assert len(resumed) == len(want) == 2
    for w, g in zip(want, resumed):
        same_arrays(w, g, "0-worker resume")
    for x, y in zip(straight[2:], resumed):
        assert torch.equal(x["ids"], y["ids"]) and torch.equal(x["labels"], y["labels"])
    assert not torch.equal(straight[2]["video"], resumed[0]["video"])


# ---- AV-HuBERT pretraining samples ------------------------------------------------


def _km_file(root: str, tmp_path, frames) -> str:
    """A .km file of random 100 Hz labels, 4 a video frame plus a ragged
    tail, one row a clip of the corpus."""
    rng = np.random.default_rng(6)
    path = tmp_path / "train.km"
    path.write_text("".join(" ".join(map(str, rng.integers(0, 50, 4 * f + (i % 3))))
                            + "\n" for i, f in enumerate(frames)))
    return str(path)


@pytest.mark.parametrize("subset", ["valid", "train"])
def test_pretrain_dataset_matches_jax(corpus, tmp_path, subset, monkeypatch):
    """``PretrainDataset``: the samples (video, stacked filterbank, labels
    decimated to 25 Hz, cut to the shortest) and the collated batches bit
    for bit.  The JAX train subset draws its crops from an unseeded
    generator: here it is handed one generator seeded as the port's (the
    dataset seed), which the port's 0-worker loader draws from in order."""
    import functools

    root, _ = corpus
    frames = [e.n_video_frames for e in tmanifest.load_manifest(f"{root}/{subset}.tsv").entries]
    km = _km_file(root, tmp_path, frames)
    if subset == "train":
        monkeypatch.setattr(jdataset, "transform_video", functools.partial(
            jvideo.transform_video, rng=np.random.default_rng(1)))
    kw = dict(km_path=km, max_video_frames=60, image_crop_size=40, length_buckets=(16, 32, 64))
    jds = jdataset.PretrainDataset(root, subset, **kw)
    tds = tdataset.PretrainDataset(root, subset, **kw)
    assert len(tds) == len(jds) and tds.sizes() == jds.sizes()
    for w, g in zip(jds.labels, tds.labels):
        np.testing.assert_array_equal(g, w)
    batches = tds.batches(max_tokens=130, epoch=1)
    for w, g in zip(jds.batches(max_tokens=130, epoch=1), batches):
        np.testing.assert_array_equal(g, w)
    want = [jds.collate([jds[int(i)] for i in idx]) for idx in batches]
    for w, g in zip(want, tdataset.BatchLoader(tds, batches, num_workers=0)):
        same_arrays(w, g, f"pretrain {subset}")
        assert g["audio"].shape[-1] == 104


def test_pretrain_task_dataset_and_workers(corpus, tmp_path):
    """The task's ``load_dataset`` with its config, and the loader's worker
    draws: the same batches at 1 and 2 workers, distinct crops a batch."""
    root, _ = corpus
    frames = [e.n_video_frames for e in tmanifest.load_manifest(f"{root}/train.tsv").entries]
    km = _km_file(root, tmp_path, frames)
    cfg = dict(data=root, km_path=km, max_video_frames=60, image_crop_size=40,
               length_buckets=(16, 32, 64))
    jds = jtasks.AVHubertPretrainTask(jtasks.AVHubertPretrainTaskConfig(**cfg)).load_dataset(
        "valid")
    tds = ttasks.AVHubertPretrainTask(ttasks.AVHubertPretrainTaskConfig(**cfg),
                                      device="cpu").load_dataset("valid")
    same_arrays(jds.collate([jds[0], jds[1]]), tds.load_batch([0, 1]), "task valid batch")
    train = ttasks.AVHubertPretrainTask(ttasks.AVHubertPretrainTaskConfig(**cfg),
                                        device="cpu").load_dataset("train")
    batches = [np.asarray([0, 1])] * 3
    one = list(tdataset.BatchLoader(train, batches, num_workers=1, epoch=2))
    two = list(tdataset.BatchLoader(train, batches, num_workers=2, epoch=2))
    for x, y in zip(one, two):
        same_arrays({k: v.numpy() for k, v in x.items()}, y, "one vs two workers")
    assert not torch.equal(two[0]["video"], two[1]["video"])
    assert torch.equal(two[0]["targets"], two[1]["targets"])

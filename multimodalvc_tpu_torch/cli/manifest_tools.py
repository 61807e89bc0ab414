"""Manifest tools: the manifests, the offline targets and the AV-HuBERT
pretraining-label pipeline.

Port of ``multimodalvc_tpu/cli/manifest_tools.py``: its twelve subcommands
with the JAX arguments, defaults and outputs::

  python -m multimodalvc_tpu_torch.cli.manifest_tools generate \
      --root DIR --video-dir video --text-dir text --out-tsv DIR/all.tsv
  python -m multimodalvc_tpu_torch.cli.manifest_tools split \
      --tsv DIR/all.tsv --out-dir DIR                  # train / valid / test
  python -m multimodalvc_tpu_torch.cli.manifest_tools hours --tsv DIR/train.tsv
  python -m multimodalvc_tpu_torch.cli.manifest_tools normalize-rates --tsv T
  python -m multimodalvc_tpu_torch.cli.manifest_tools update-paths \
      --tsv T --old /a --new /b
  python -m multimodalvc_tpu_torch.cli.manifest_tools generate-mels --tsv T
  python -m multimodalvc_tpu_torch.cli.manifest_tools make-babble \
      --tsv T --out babble.wav
  python -m multimodalvc_tpu_torch.cli.manifest_tools filter-language \
      --tsv T --meta meta.csv --out T.de
  python -m multimodalvc_tpu_torch.cli.manifest_tools align-mouth \
      --video clip.npy --landmarks clip_lm.npy --out clip_roi.npy
  python -m multimodalvc_tpu_torch.cli.manifest_tools learn-kmeans \
      --tsv DIR/train.tsv --out km.npy                 # iteration 1: MFCCs
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-labels \
      --tsv DIR/train.tsv --centroids km.npy --out DIR/train.km
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-features \
      --tsv DIR/train.tsv --ckpt checkpoints/avhubert-pretrain --out feats
  python -m multimodalvc_tpu_torch.cli.manifest_tools learn-kmeans \
      --features feats --out km2.npy                   # iteration 2
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-labels \
      --features feats --centroids km2.npy --out DIR/train.km

``generate`` reads ``.npy`` clips with numpy and ``.mp4`` ones through cv2,
imported only then; ``generate-mels`` writes ``*_mel_100hz_128bands.npy``
beside each wav (``data/audio.py: hifigan_mel_np``, which the training
dataset reads when present); ``align-mouth`` crops mouth ROIs through
``data/roi.py`` from precomputed ``--landmarks`` (or, with mediapipe or dlib
installed, detected ones).  These run on the host.

The files are the JAX package's: a feature dump is ``{out}.npy`` (the clips'
frames concatenated, [sum_T, D] f32) beside ``{out}.len`` (a clip's frame
count a line); centroids a ``.npy`` [K, D]; labels a ``.km`` text file, a
clip's space-separated labels a line.  Either package reads what the other
writes.  The k-means and the feature dump run on the card unless
``--device cpu``.  The dump runs the model in f32, as the JAX tool does;
``--dtype bfloat16`` runs it in bf16, where the attention of clips padded
to 256 frames or more launches the flash kernel.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..data.clustering import MiniBatchKMeans

logger = logging.getLogger(__name__)


def _clip_metadata(video_path: str, text_dir_name: Optional[str], video_dir_name: str):
    """(tsv_line, transcript) for one clip; None on failure."""
    from scipy.io import wavfile

    wav_path = os.path.splitext(video_path)[0] + ".wav"
    if not os.path.exists(wav_path):
        return None
    sr, data = wavfile.read(wav_path)  # header+data; scipy lacks info-only
    n_aud = data.shape[0]
    if video_path.endswith(".npy"):
        n_vid = int(np.load(video_path, mmap_mode="r").shape[0])
    else:
        import cv2

        cap = cv2.VideoCapture(video_path)
        n_vid = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    text = ""
    if text_dir_name:
        txt_path = video_path.replace(video_dir_name, text_dir_name)
        txt_path = os.path.splitext(txt_path)[0] + ".txt"
        if not os.path.exists(txt_path):
            return None
        with open(txt_path, encoding="utf-8") as f:
            text = f.read().strip().lower()
        if not text:
            return None
    duration = n_aud / 16000.0
    rate = round(len(text.split()) / duration, 2) if (text and duration > 0) else 0.0
    line = f"dataset\t{video_path}\t{wav_path}\t{n_vid}\t{n_aud}\t{rate}"
    return line, text


def cmd_generate(args):
    video_root = os.path.join(args.root, args.video_dir)
    patterns = ("*.mp4", "*.npy")
    files: List[str] = []
    for p in patterns:
        files += glob.glob(os.path.join(video_root, "**", p), recursive=True)
    files.sort()
    print(f"processing {len(files)} clips with {args.workers} workers")
    with ThreadPoolExecutor(args.workers) as pool:
        results = list(
            pool.map(lambda f: _clip_metadata(f, args.text_dir, args.video_dir), files)
        )
    valid = [r for r in results if r is not None]
    with open(args.out_tsv, "w", encoding="utf-8") as f:
        f.write("/\n")
        for line, _ in valid:
            f.write(line + "\n")
    if args.text_dir:
        with open(os.path.splitext(args.out_tsv)[0] + ".wrd", "w", encoding="utf-8") as f:
            for _, text in valid:
                f.write(text + "\n")
    print(f"wrote {len(valid)} entries -> {args.out_tsv}")


def cmd_split(args):
    """Split a tsv(+wrd) into train/valid/test (src/splitDataset.py:4-93)."""
    with open(args.tsv) as f:
        root = f.readline()
        rows = f.readlines()
    wrd_path = os.path.splitext(args.tsv)[0] + ".wrd"
    labels = None
    if os.path.exists(wrd_path):
        with open(wrd_path) as f:
            labels = f.readlines()
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(rows))
    n_valid = int(len(rows) * args.valid_frac)
    n_test = int(len(rows) * args.test_frac)
    splits = {
        "valid": order[:n_valid],
        "test": order[n_valid : n_valid + n_test],
        "train": order[n_valid + n_test :],
    }
    for name, idx in splits.items():
        with open(os.path.join(args.out_dir, f"{name}.tsv"), "w") as f:
            f.write(root)
            for i in sorted(idx):
                f.write(rows[i])
        if labels:
            with open(os.path.join(args.out_dir, f"{name}.wrd"), "w") as f:
                for i in sorted(idx):
                    f.write(labels[i])
        print(f"{name}: {len(idx)}")


def cmd_hours(args):
    """Total audio hours in a manifest (src/countHours.py:1-39)."""
    total = 0
    with open(args.tsv) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 5:
                total += int(parts[4])
    secs = total / 16000.0
    print(f"total samples: {total}\ntotal seconds: {secs:.2f}\ntotal hours: {secs / 3600:.2f}")


def cmd_normalize_rates(args):
    """Clamp/standardize the speech-rate column to a target band
    (manifest/germanManifest/normalize_rates.py)."""
    with open(args.tsv) as f:
        root = f.readline()
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    rates = np.asarray([float(r[5]) if len(r) > 5 and r[5] else 0.0 for r in rows])
    valid = rates > 0
    mean = rates[valid].mean() if valid.any() else 1.0
    # map absolute words/sec onto the SR predictor's [1, 2] factor band
    norm = np.clip(rates / max(mean, 1e-6), args.min_rate, args.max_rate)
    out = args.out or args.tsv
    with open(out, "w") as f:
        f.write(root)
        for r, nr in zip(rows, norm):
            r = r[:5] + [f"{nr:.2f}"]
            f.write("\t".join(r) + "\n")
    print(f"normalized {len(rows)} rates (mean raw={mean:.2f}) -> {out}")


def cmd_update_paths(args):
    """Rewrite a path prefix in manifests (manifest/update_dataset_paths.py)."""
    with open(args.tsv) as f:
        content = f.read()
    content = content.replace(args.old, args.new)
    with open(args.out or args.tsv, "w") as f:
        f.write(content)
    print("updated paths")


def _mel_one(task):
    """Extract one wav's 128-band 100 Hz log-mel target next to the wav
    (reference: src/generateLogMel-Spectrograms.py:1-132, librosa n_fft=1024
    hop=160 fmax=8000 center=False reflect-pad natural-log clamp 1e-5)."""
    from ..data.audio import hifigan_mel_np, read_wav

    wav_path, overwrite = task
    out_path = os.path.splitext(wav_path)[0] + "_mel_100hz_128bands.npy"
    if os.path.exists(out_path) and not overwrite:
        return 0
    try:
        mel = hifigan_mel_np(read_wav(wav_path))  # [T, 128]
        np.save(out_path, mel.astype(np.float32))
        return 1
    except Exception as e:  # unreadable wav — skip, report
        logger.warning("%s: %s", wav_path, e)
        return 0


def cmd_generate_mels(args):
    """Offline mel-target extraction over a manifest, multiprocessing Pool
    with SLURM CPU detection like the reference (:96-110)."""
    from multiprocessing import get_context

    wavs = []
    with open(args.tsv) as f:
        root = f.readline().strip()
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3:
                continue
            audio = cols[2].split(":")[0]
            wavs.append(audio if os.path.isabs(audio) else os.path.join(root, audio))
    workers = args.workers or int(
        os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 1)
    )
    tasks = [(w, args.overwrite) for w in sorted(set(wavs))]
    if workers <= 1:
        done = sum(_mel_one(t) for t in tasks)
    else:  # spawned workers: a fork of a process with threads may hang
        with get_context("spawn").Pool(workers) as pool:
            done = sum(pool.map(_mel_one, tasks, chunksize=16))
    print(f"wrote {done}/{len(tasks)} mel targets")


def cmd_make_babble(args):
    """Mix N random manifest utterances into a babble-noise track
    (reference: avhubert/preparation/lrs3_noise.py mix_audio — overlap-add
    of 30 normalised utterances)."""
    from ..data.audio import read_wav, write_wav

    wavs = []
    with open(args.tsv) as f:
        root = f.readline().strip()
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 3:
                a = cols[2].split(":")[0]
                wavs.append(a if os.path.isabs(a) else os.path.join(root, a))
    rng = np.random.default_rng(args.seed)
    pick = rng.choice(len(wavs), size=min(args.n, len(wavs)), replace=False)
    tracks = [read_wav(wavs[i]) for i in pick]
    t = max(len(w) for w in tracks)
    mix = np.zeros(t, np.float32)
    for w in tracks:
        reps = int(np.ceil(t / len(w)))
        tiled = np.tile(w, reps)[:t]
        mix += tiled / max(np.abs(tiled).max(), 1e-6)
    mix = mix / max(np.abs(mix).max(), 1e-6) * 0.95
    write_wav(args.out, mix)
    print(f"mixed {len(tracks)} utterances -> {args.out} ({t / 16000:.1f} s)")


def cmd_filter_language(args):
    """Filter manifest rows by a clip-id -> language metadata CSV
    (reference: src/germanDatasetExtraction.py — VoxCeleb2 rows with
    language == 'de' selected from the metadata dump; ids are matched as
    substrings of the clip's video path, e.g. 'id00017/abc123')."""
    lang_ids = set()
    with open(args.meta) as f:
        header = f.readline().rstrip("\n").split(",")
        id_col = header.index(args.id_column)
        lang_col = header.index(args.language_column)
        for line in f:
            cols = line.rstrip("\n").split(",")
            if len(cols) > max(id_col, lang_col) and cols[lang_col].strip() == args.language:
                lang_ids.add(cols[id_col].strip())
    kept, total = 0, 0
    wrd_in = open(args.wrd) if args.wrd else None
    wrd_out = open(args.out + ".wrd", "w") if args.wrd else None
    with open(args.tsv) as f, open(args.out, "w") as out:
        out.write(f.readline())
        for line in f:
            total += 1
            label = wrd_in.readline() if wrd_in else None
            video = line.split("\t")[1] if "\t" in line else ""
            if any(cid in video for cid in lang_ids):
                out.write(line)
                if wrd_out is not None and label is not None:
                    wrd_out.write(label)
                kept += 1
    if wrd_in:
        wrd_in.close()
        wrd_out.close()
    print(f"kept {kept}/{total} clips with language={args.language}")


def cmd_align_mouth(args):
    """Landmark-driven mouth-ROI extraction for one clip
    (avhubert/preparation/align_mouth.py analog): video .npy [T, H, W] +
    landmarks .npy [T, 68, 2] -> ROI .npy [T, 2*ch, 2*cw]."""
    from ..data.roi import crop_mouth_rois, default_mean_face, detect_landmarks

    frames = np.load(args.video)
    if args.landmarks:
        lms = np.load(args.landmarks)
        landmarks = [lm if np.isfinite(lm).all() else None for lm in lms]
    else:
        # on-the-fly detection (reference: detect_landmark.py stage) — needs
        # mediapipe or dlib; precomputed --landmarks stays the offline path
        landmarks = detect_landmarks(frames, backend=args.detector or None)
    mean_face = (
        np.load(args.mean_face) if args.mean_face else default_mean_face(args.std_size)
    )
    rois = crop_mouth_rois(
        frames,
        landmarks,
        mean_face,
        std_size=args.std_size,
        window_margin=args.window_margin,
        crop_height=args.crop // 2,
        crop_width=args.crop // 2,
    )
    if rois is None:
        raise SystemExit("no valid landmarks in clip")
    np.save(args.out, rois)
    print(f"wrote {rois.shape} -> {args.out}")


def _read_feature_dump(prefix: str) -> Tuple[np.ndarray, List[int]]:
    """A dump-features output: {prefix}.npy [sum_T, D] and {prefix}.len (the
    frame count of each clip, one a manifest row)."""
    feats = np.load(prefix + ".npy")
    with open(prefix + ".len") as f:
        lens = [int(x) for x in f.read().split()]
    if sum(lens) != len(feats):
        raise ValueError(
            f"{prefix}.len sums to {sum(lens)} but {prefix}.npy has {len(feats)} rows")
    return feats, lens


def cmd_dump_features(args) -> None:
    """The state after encoder layer ``--layer`` (0: the fused front end) of
    the model in a ``cli.train`` checkpoint, unmasked, for each clip of the
    manifest, into {out}.npy / {out}.len.  Each clip is padded to a multiple
    of 32 frames, as in the JAX tool."""
    from .. import tasks as _tasks  # noqa: F401 (registers the models)
    from ..config.registry import lookup
    from ..data.audio import read_wav, stacked_logfbank_np
    from ..data.manifest import load_manifest, resolve_path
    from ..data.video import load_video_frames, transform_video
    from ..runtime.checkpoint import CheckpointManager, load_model

    cls, cfg_cls = lookup("model", args.model)
    model_cfg = getattr(cfg_cls, args.preset)() if args.preset else cfg_cls()
    module = cls.from_config(model_cfg, dtype=getattr(torch, args.dtype),
                             device=args.device).module
    state = CheckpointManager(args.ckpt).restore(name=args.ckpt_name, map_location="cpu")
    if state is None:
        raise FileNotFoundError(f"no {args.ckpt_name} under {args.ckpt}")
    load_model(module, state)
    manifest = load_manifest(args.tsv, max_keep_frames=args.max_frames)
    dev = torch.device(args.device)
    feats, lens = [], []
    for e in manifest.entries:
        video = transform_video(load_video_frames(resolve_path(manifest.root, e.video_path)),
                                crop_size=args.crop_size, train=False)
        audio = stacked_logfbank_np(read_wav(resolve_path(manifest.root, e.audio_path)))
        t = min(len(video), len(audio))
        tp = ((t + 31) // 32) * 32
        video = np.pad(video[:t], ((0, tp - t),) + ((0, 0),) * (video.ndim - 1))
        audio = np.pad(audio[:t], ((0, tp - t), (0, 0)))
        with torch.no_grad():
            h = module(torch.from_numpy(audio[None]).to(dev), torch.from_numpy(video[None]).to(dev),
                       torch.zeros((1, tp), dtype=torch.int32, device=dev),
                       torch.tensor([t], dtype=torch.int32, device=dev), train=False,
                       output_layer=args.layer)
        feats.append(h[0, :t].float().cpu().numpy())
        lens.append(t)
    out = np.concatenate(feats, axis=0)
    np.save(args.out + ".npy", out)
    with open(args.out + ".len", "w") as f:
        f.write("\n".join(map(str, lens)) + "\n")
    print(f"dumped layer-{args.layer} features for {len(lens)} clips "
          f"({out.shape[0]} frames x {out.shape[1]}) -> {args.out}.npy/.len")


def cmd_learn_kmeans(args) -> MiniBatchKMeans:
    """Fit mini-batch k-means and save the centroids, on the MFCCs of the
    clips of --tsv (iteration 1) or on a dump-features output --features
    (iteration 2 on)."""
    from ..data.audio import read_wav
    from ..data.clustering import MiniBatchKMeans, manifest_audio_paths, mfcc_np

    if args.features:
        all_feats, _ = _read_feature_dump(args.features)
    else:
        all_feats = np.concatenate([mfcc_np(read_wav(p)) for p in manifest_audio_paths(args.tsv)],
                                   axis=0)
    if 0 < args.percent < 1.0:
        rng = np.random.default_rng(0)
        keep = rng.choice(len(all_feats), int(len(all_feats) * args.percent), replace=False)
        all_feats = all_feats[keep]
    km = MiniBatchKMeans(args.clusters, batch_size=args.batch_size, device=args.device).fit(
        all_feats, epochs=args.epochs)
    km.save(args.out)
    print(f"fit {args.clusters} clusters on {len(all_feats)} frames -> {args.out}")
    return km


def cmd_dump_labels(args) -> int:
    """Write a clip's k-means labels a line (.km) for pretraining: of its
    MFCCs (--tsv) or of its dumped activations (--features)."""
    from ..data.clustering import MiniBatchKMeans, dump_labels_for_manifest

    km = MiniBatchKMeans.load(args.centroids, device=args.device)
    if args.features:
        feats, lens = _read_feature_dump(args.features)
        labels = km.predict(feats)
        n, off = 0, 0
        with open(args.out, "w") as out:
            for t in lens:
                out.write(" ".join(map(str, labels[off: off + t].tolist())) + "\n")
                off += t
                n += 1
    else:
        n = dump_labels_for_manifest(args.tsv, km, args.out)
    print(f"wrote {n} label rows -> {args.out}")
    return n


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    df = sub.add_parser(
        "dump-features",
        help="dump intermediate AV-HuBERT activations for iteration-2 k-means")
    df.add_argument("--tsv", required=True)
    df.add_argument("--ckpt", required=True, help="checkpoint save_dir")
    df.add_argument("--ckpt-name", default="checkpoint_last")
    df.add_argument("--model", default="av_hubert_pretrain")
    df.add_argument("--preset", default=None, help="model config preset (e.g. tiny)")
    df.add_argument("--layer", type=int, default=12,
                    help="encoder layer (1-indexed); 0 = frontend features")
    df.add_argument("--max-frames", type=int, default=500)
    df.add_argument("--crop-size", type=int, default=88)
    df.add_argument("--dtype", default="float32",
                    help="the model's dtype: float32 (the JAX tool's) or bfloat16, whose "
                         "attention runs the flash kernel on the card")
    df.add_argument("--out", required=True, help="output prefix ({out}.npy/.len)")
    df.set_defaults(fn=cmd_dump_features)

    kk = sub.add_parser("learn-kmeans", help="fit k-means on MFCCs for pretraining labels")
    kk.add_argument("--tsv", default=None)
    kk.add_argument("--features", default=None,
                    help="dump-features prefix (iteration-2 model activations)")
    kk.add_argument("--clusters", type=int, default=500)
    kk.add_argument("--epochs", type=int, default=5)
    kk.add_argument("--batch-size", type=int, default=10000)
    kk.add_argument("--percent", type=float, default=1.0)
    kk.add_argument("--out", required=True)
    kk.set_defaults(fn=cmd_learn_kmeans)

    kl = sub.add_parser("dump-labels", help="write per-clip k-means labels (.km)")
    kl.add_argument("--tsv", default=None)
    kl.add_argument("--features", default=None,
                    help="dump-features prefix (iteration-2 model activations)")
    kl.add_argument("--centroids", required=True)
    kl.add_argument("--out", required=True)
    kl.set_defaults(fn=cmd_dump_labels)
    for p in (df, kk, kl):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    bb = sub.add_parser("make-babble", help="mix manifest utterances into babble noise")
    bb.add_argument("--tsv", required=True)
    bb.add_argument("--n", type=int, default=30)
    bb.add_argument("--seed", type=int, default=0)
    bb.add_argument("--out", required=True)
    bb.set_defaults(fn=cmd_make_babble)

    fl = sub.add_parser("filter-language", help="filter manifest by language metadata CSV")
    fl.add_argument("--tsv", required=True)
    fl.add_argument("--wrd", default=None, help="matching transcript file to co-filter")
    fl.add_argument("--meta", required=True, help="CSV with clip ids + language")
    fl.add_argument("--language", default="de")
    fl.add_argument("--id-column", default="id")
    fl.add_argument("--language-column", default="language")
    fl.add_argument("--out", required=True)
    fl.set_defaults(fn=cmd_filter_language)

    am = sub.add_parser("align-mouth", help="landmark-aligned mouth-ROI crop")
    am.add_argument("--video", required=True, help=".npy [T, H, W]")
    am.add_argument(
        "--landmarks", default=None,
        help=".npy [T, 68, 2]; NaN rows = missed. Omit to detect on the fly "
        "(mediapipe/dlib)",
    )
    am.add_argument(
        "--detector", default=None, choices=("mediapipe", "dlib"),
        help="landmark backend when --landmarks is omitted (default: auto)",
    )
    am.add_argument("--mean-face", default=None, help=".npy [68, 2]")
    am.add_argument("--std-size", type=int, default=256)
    am.add_argument("--window-margin", type=int, default=12)
    am.add_argument("--crop", type=int, default=96)
    am.add_argument("--out", required=True)
    am.set_defaults(fn=cmd_align_mouth)

    m = sub.add_parser("generate-mels", help="offline 128-band mel targets")
    m.add_argument("--tsv", required=True)
    m.add_argument("--workers", type=int, default=0)
    m.add_argument("--overwrite", action="store_true")
    m.set_defaults(fn=cmd_generate_mels)

    g = sub.add_parser("generate")
    g.add_argument("--root", required=True)
    g.add_argument("--video-dir", default="video")
    g.add_argument("--text-dir", default=None)
    g.add_argument("--out-tsv", required=True)
    g.add_argument("--workers", type=int, default=8)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("split")
    s.add_argument("--tsv", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--valid-frac", type=float, default=0.05)
    s.add_argument("--test-frac", type=float, default=0.05)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_split)

    h = sub.add_parser("hours")
    h.add_argument("--tsv", required=True)
    h.set_defaults(fn=cmd_hours)

    n = sub.add_parser("normalize-rates")
    n.add_argument("--tsv", required=True)
    n.add_argument("--out", default=None)
    n.add_argument("--min-rate", type=float, default=1.0)
    n.add_argument("--max-rate", type=float, default=2.0)
    n.set_defaults(fn=cmd_normalize_rates)

    u = sub.add_parser("update-paths")
    u.add_argument("--tsv", required=True)
    u.add_argument("--old", required=True)
    u.add_argument("--new", required=True)
    u.add_argument("--out", default=None)
    u.set_defaults(fn=cmd_update_paths)
    return parser


def main(argv=None):
    """Run one subcommand; returns what it returns (the fitted k-means, the
    label rows written)."""
    args = build_parser().parse_args(list(sys.argv[1:] if argv is None else argv))
    return args.fn(args)


if __name__ == "__main__":
    main()

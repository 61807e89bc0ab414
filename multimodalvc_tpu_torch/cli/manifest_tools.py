"""Manifest tools: the AV-HuBERT pretraining-label pipeline.

Port of ``multimodalvc_tpu/cli/manifest_tools.py``'s ``dump-features``,
``learn-kmeans`` and ``dump-labels``, with the JAX arguments and
defaults::

  python -m multimodalvc_tpu_torch.cli.manifest_tools learn-kmeans \\
      --tsv DIR/train.tsv --out km.npy                 # iteration 1: MFCCs
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-labels \\
      --tsv DIR/train.tsv --centroids km.npy --out DIR/train.km
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-features \\
      --tsv DIR/train.tsv --ckpt checkpoints/avhubert-pretrain --out feats
  python -m multimodalvc_tpu_torch.cli.manifest_tools learn-kmeans \\
      --features feats --out km2.npy                   # iteration 2
  python -m multimodalvc_tpu_torch.cli.manifest_tools dump-labels \\
      --features feats --centroids km2.npy --out DIR/train.km

The files are the JAX package's: a feature dump is ``{out}.npy`` (the clips'
frames concatenated, [sum_T, D] f32) beside ``{out}.len`` (a clip's frame
count a line); centroids a ``.npy`` [K, D]; labels a ``.km`` text file, a
clip's space-separated labels a line.  Either package reads what the other
writes.  The k-means and the feature dump run on the card unless
``--device cpu``.  The dump runs the model in f32, as the JAX tool does;
``--dtype bfloat16`` runs it in bf16, where the attention of clips padded
to 256 frames or more launches the flash kernel.  The other subcommands of
the JAX tool are not ported (ROADMAP queue 1 item 6): ``main`` refuses
them.
"""
from __future__ import annotations

import argparse
import sys
from typing import TYPE_CHECKING, List, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..data.clustering import MiniBatchKMeans

NOT_PORTED = ("make-babble", "filter-language", "align-mouth", "generate-mels", "generate",
              "split", "hours", "normalize-rates", "update-paths")


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
    return parser


def main(argv=None):
    """Run one subcommand; returns what it returns (the fitted k-means, the
    label rows written)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        raise NotImplementedError(
            f"manifest_tools {argv[0]} is not ported (ROADMAP queue 1 item 6); the port has "
            "dump-features, learn-kmeans and dump-labels")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

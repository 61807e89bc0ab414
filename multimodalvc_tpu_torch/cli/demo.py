"""One-clip AVSR demo: one video and one wav to a transcript.

Port of ``multimodalvc_tpu/cli/demo.py``::

  python -m multimodalvc_tpu_torch.cli.demo --config conf/s2s_decode.yaml \\
      --video clip.npy --audio clip.wav checkpoint.save_dir=checkpoints/mms-llama

Builds the task of the configuration, restores ``checkpoint.restore_file``
from ``checkpoint.save_dir`` (random weights from seed 0, with a warning,
when there is none), preprocesses the clip as evaluation does (the center
crop; the Whisper features cut to the encoder's window; the instruction),
beam-decodes it with ``AVSRSystem.generate``'s defaults and prints the best
beam, cut at EOS, as ``TRANSCRIPT: ...``.  ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..config import TrainRootConfig, apply_overrides, from_dict, load_yaml, merge
from ..data.audio import read_wav, whisper_features_np
from ..data.tokenizer import INSTRUCTION_TEXT, load_tokenizer
from ..data.video import load_video_frames, transform_video
from ..runtime.checkpoint import CheckpointManager, load_model
from .train import build_task

logger = logging.getLogger(__name__)


def clip_batch(video_path: str, audio_path: str, whisper_frames: int, tokenizer, device) -> dict:
    """The generate batch of one clip: the video center-cropped and
    normalized [1, T, 88, 88, 1], the Whisper features of the wav cut to
    ``2 * whisper_frames`` mel frames, the lengths and the instruction."""
    video = transform_video(load_video_frames(video_path))[None]
    wav = read_wav(audio_path)
    feats = whisper_features_np(wav)[None][:, :, : 2 * whisper_frames]
    batch = {
        "video": torch.from_numpy(video),
        "video_lengths": torch.tensor([video.shape[1]], dtype=torch.int32),
        "audio_feats": torch.from_numpy(np.ascontiguousarray(feats)),
        "audio_lengths": torch.tensor([len(wav)], dtype=torch.int32),
        "instruction": torch.tensor([tokenizer.encode(INSTRUCTION_TEXT)], dtype=torch.int32),
    }
    return {k: v.to(device) for k, v in batch.items()}


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="conf/s2s_decode.yaml")
    parser.add_argument("--video", required=True)
    parser.add_argument("--audio", required=True)
    parser.add_argument("--beams", type=int, default=5)
    parser.add_argument("--max-len", type=int, default=100)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    tree: dict = {}
    if args.config:
        merge(tree, load_yaml(args.config))
    apply_overrides(tree, args.overrides)
    # the demo reads no manifest; satisfy the dataset field
    tree.setdefault("dataset", {})["data"] = tree.get("dataset", {}).get("data", ".")
    cfg = from_dict(TrainRootConfig, tree)
    task = build_task(cfg, args.device)
    mcfg = task.model_cfg

    tok = load_tokenizer(cfg.task.get("llm_path"))
    mcfg.eos_token_id = tok.eos_token_id
    mcfg.pad_token_id = tok.pad_token_id
    batch = clip_batch(args.video, args.audio, mcfg.whisper.max_frames, tok, args.device)

    restored = CheckpointManager(cfg.checkpoint.save_dir).restore(
        name=cfg.checkpoint.restore_file, map_location="cpu")
    if restored is not None:
        load_model(task.module, restored)
    else:
        logger.warning("no checkpoint restored — output will be noise")
        task.init_random(0)

    seqs, _ = task.system.generate(batch, num_beams=args.beams, max_new_tokens=args.max_len)
    toks = []
    for t in seqs[0, 0].tolist():
        if t == mcfg.eos_token_id:
            break
        toks.append(t)
    text = tok.decode(toks)
    print("TRANSCRIPT:", text)
    return text


if __name__ == "__main__":
    main()

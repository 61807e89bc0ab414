"""Speech generation CLI: a mel to a waveform through the vocoder, or an AV clip
to a waveform through the NoLLM speech head and the vocoder.

Port of ``multimodalvc_tpu/cli/generate.py``::

  python -m multimodalvc_tpu_torch.cli.generate vocode --mel mel.npy \\
      --checkpoint checkpoints/hifigan/checkpoint_best --out out.wav
  python -m multimodalvc_tpu_torch.cli.generate synthesize --video clip.npy \\
      --audio clip.wav --preset "" --checkpoint checkpoints/mms-speech-nollm --out synth.wav

``vocode`` takes a reference ``.pt`` (``VocoderModel.import_torch_checkpoint``)
or a checkpoint the vocoder training loop wrote (its EMA generator, or the
trained one with ``--no-ema``).  ``synthesize`` restores the speech head
from a speech training run's ``checkpoint_last``; without a checkpoint a
model takes random weights (the speech head seed 0, the vocoder seed 1).
The speech head runs in bf16 on the card and f32 on the CPU, the vocoder in
f32.  ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..data.audio import read_wav, whisper_features_np, write_wav
from ..data.video import transform_video
from ..models.speech import SpeechConfig, SpeechNoLLMSystem, synthesize
from ..models.vocoder import VocoderConfig, VocoderModel
from ..runtime.checkpoint import CheckpointManager, load_model

logger = logging.getLogger(__name__)


def load_vocoder(path, device, use_ema: bool = True, seed: int = 1) -> VocoderModel:
    """``VocoderConfig()`` in f32 on ``device``: from a reference ``.pt``,
    from a vocoder training checkpoint directory, or random from ``seed``."""
    voc = VocoderModel(VocoderConfig(), device=device)
    if path and path.endswith((".pt", ".pth")):
        voc.import_torch_checkpoint(path, use_ema=use_ema)
    elif path:
        state = CheckpointManager(os.path.dirname(path.rstrip("/")) or ".").restore(
            name=os.path.basename(path.rstrip("/")), map_location=device)
        if state is None:
            raise SystemExit(f"no restorable checkpoint at {path}")
        own = voc.generator.state_dict()
        with torch.no_grad():
            for n, x in state["ema" if use_ema else "generator"].items():
                own[n].copy_(x)
        logger.info("restored the vocoder from %s", path)
    else:
        logger.warning("no vocoder checkpoint: random weights (seed %d)", seed)
        voc.init_random(seed)
    return voc


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="mode", required=True)

    voc = sub.add_parser("vocode", help="mel (.npy [T, 128]) -> wav")
    voc.add_argument("--mel", required=True)
    voc.add_argument("--checkpoint", help="reference .pt or a vocoder training checkpoint")
    voc.add_argument("--out", default="out.wav")
    voc.add_argument("--ema", action=argparse.BooleanOptionalAction, default=True)
    voc.add_argument("--device", default="cuda")

    syn = sub.add_parser("synthesize",
                         help="AV clip -> waveform via the NoLLM speech model + vocoder")
    syn.add_argument("--video", required=True, help=".npy [T, H, W]")
    syn.add_argument("--audio", required=True, help="16 kHz wav")
    syn.add_argument("--checkpoint", help="save dir of a NoLLM speech training run")
    syn.add_argument("--vocoder-checkpoint", help="reference .pt or a vocoder checkpoint")
    syn.add_argument("--preset", default="tiny", help='a SpeechConfig preset; "" = full width')
    syn.add_argument("--out", default="synth.wav")
    syn.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.mode == "vocode":
        model = load_vocoder(args.checkpoint, args.device, use_ema=args.ema, seed=0)
        mel = np.load(args.mel).astype(np.float32)
        if mel.ndim == 2:
            mel = mel[None]
        wav = model.generate(torch.from_numpy(mel).to(args.device))[0]
        write_wav(args.out, wav.float().cpu().numpy())
        logger.info("wrote %s (%.2f s)", args.out, wav.shape[0] / 16000)
    else:
        _synthesize(args)


def load_speech(checkpoint, preset: str, device) -> SpeechNoLLMSystem:
    """The NoLLM speech head of ``SpeechConfig.<preset>()`` ("" the full
    width), in bf16 on the card and f32 on the CPU: restored from the
    ``checkpoint_last`` of a speech training run's save dir, or random from
    seed 0."""
    device = torch.device(device)
    cfg = getattr(SpeechConfig, preset)() if preset else SpeechConfig()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    system = SpeechNoLLMSystem(cfg, dtype=dtype, device=device)
    state = CheckpointManager(checkpoint).restore(map_location="cpu") if checkpoint else None
    if state is not None:
        load_model(system.module, state)
        logger.info("restored the speech model from %s", checkpoint)
    else:
        logger.warning("no speech checkpoint: random weights (seed 0)")
        system.init_random(0)
    return system


def clip_batch(video, audio, cfg: SpeechConfig, preset: str, device) -> dict:
    """One clip's batch: the ``.npy`` mouth ROI center-cropped (24 px at the
    tiny preset, else 88) and cut to ``max_video_frames``, the wav's
    Whisper features cut to the encoder's window."""
    crop = 24 if preset == "tiny" else 88
    frames = transform_video(np.load(video), crop_size=crop, train=False)
    wav_in = read_wav(audio)
    t_v = min(frames.shape[0], cfg.max_video_frames)
    feats = whisper_features_np(wav_in)[None, :, : 2 * cfg.whisper.max_frames]
    return {
        "video": torch.from_numpy(np.ascontiguousarray(frames[None, :t_v])).to(device),
        "video_lengths": torch.tensor([t_v], dtype=torch.int32, device=device),
        "audio_feats": torch.from_numpy(np.ascontiguousarray(feats)).to(device),
        "audio_lengths": torch.tensor([len(wav_in)], dtype=torch.int32, device=device),
    }


def _synthesize(args):
    """One clip: video + audio -> the NoLLM mel head -> the vocoder."""
    system = load_speech(args.checkpoint, args.preset, args.device)
    batch = clip_batch(args.video, args.audio, system.cfg, args.preset, args.device)
    voc = load_vocoder(args.vocoder_checkpoint, args.device)
    wav = synthesize(system, voc, batch)[0]
    write_wav(args.out, wav.float().cpu().numpy())
    logger.info("wrote %s (%.2f s)", args.out, wav.shape[0] / 16000)


if __name__ == "__main__":
    main()

"""TSV manifest parsing and label files.

Port of ``multimodalvc_tpu/data/manifest.py``.  The first line of a manifest
is the dataset root; each row is
  dataset \t video_path \t audio_path[:id] \t n_video_frames \t n_audio_samples [\t speech_rate]
Transcripts live in a parallel ``.wrd`` file, one line per manifest row;
rows outside the frame limits are dropped together with their labels.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ManifestEntry:
    dataset: str
    video_path: str
    audio_path: str
    audio_id: str
    n_video_frames: int
    n_audio_samples: int
    speech_rate: float = 1.0


@dataclass
class Manifest:
    root: str
    entries: List[ManifestEntry]
    labels: Optional[List[str]] = None

    def __len__(self):
        return len(self.entries)

    def sizes(self) -> List[int]:
        return [e.n_video_frames for e in self.entries]


def load_manifest(
    tsv_path: str,
    max_keep_frames: Optional[int] = None,
    min_keep_frames: Optional[int] = None,
    label_path: Optional[str] = None,
) -> Manifest:
    entries: List[ManifestEntry] = []
    kept_idx: List[int] = []
    n_long = n_short = 0
    with open(tsv_path) as f:
        root = f.readline().strip()
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            dataset, video, audio, n_vid, n_aud = parts[:5]
            rate = float(parts[5]) if len(parts) > 5 and parts[5] else 1.0
            n_vid = int(n_vid)
            audio_path, _, audio_id = audio.partition(":")
            if max_keep_frames is not None and n_vid > max_keep_frames:
                n_long += 1
                continue
            if min_keep_frames is not None and n_vid < min_keep_frames:
                n_short += 1
                continue
            entries.append(ManifestEntry(
                dataset=dataset,
                video_path=video,
                audio_path=audio_path,
                audio_id=audio_id or os.path.splitext(os.path.basename(audio_path))[0],
                n_video_frames=n_vid,
                n_audio_samples=int(n_aud),
                speech_rate=rate,
            ))
            kept_idx.append(i)
    labels = None
    if label_path is not None:
        with open(label_path) as f:
            all_labels = [ln.rstrip("\n") for ln in f]
        labels = [all_labels[i] for i in kept_idx]
        if len(labels) != len(entries):
            raise ValueError(
                f"label/manifest mismatch: {len(labels)} labels vs {len(entries)} entries")
    logger.info("manifest %s: kept %d, skipped %d too-long %d too-short", tsv_path,
                len(entries), n_long, n_short)
    return Manifest(root=root, entries=entries, labels=labels)


def resolve_path(root: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(root, path)

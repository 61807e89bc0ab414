"""The data pipeline: manifests, tokenizers, host audio and video features,
bucketed batches, and the loader."""
from .audio import NoiseMixer, hifigan_mel_np, read_wav, whisper_features_np, write_wav  # noqa: F401
from .batching import batch_by_size, bucket_for, pad_to  # noqa: F401
from .dataset import AVSRDataset, AVSRDatasetConfig, BatchLoader  # noqa: F401
from .manifest import Manifest, ManifestEntry, load_manifest  # noqa: F401
from .tokenizer import CharTokenizer, load_tokenizer  # noqa: F401
from .video import load_video_frames, transform_video  # noqa: F401

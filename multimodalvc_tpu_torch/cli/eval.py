"""WER evaluation CLI: batched beam-search decode over a test manifest.

Port of ``multimodalvc_tpu/cli/eval.py``::

  python -m multimodalvc_tpu_torch.cli.eval --config conf/s2s_decode.yaml \\
      dataset.data=/path/manifest checkpoint.save_dir=checkpoints/mms-llama

Restores ``checkpoint.restore_file`` from ``checkpoint.save_dir`` (a
comma-separated list decodes an ensemble: ``checkpoint.ensemble_mode``
"logprob" averages the members' log-probs each step, "average" their
weights), decodes the ``test`` subset with the ``generation`` options
(``weight_quant`` int8 / int4, ``kv_cache_quant``, ``ancestry_decode``,
``encoder_microbatch``, ``no_repeat_ngram_size``, ``constraints_file``) and
writes ``hypo-<tag>.json`` and ``wer.<tag>`` under ``--results``, the tag
the JAX package's hash of the generation options.  ``--device cpu`` runs on
the CPU.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, List

from ..config.configs import TrainRootConfig
from ..data.dataset import to_device
from ..models.avsr import AVSRSystem
from ..runtime.checkpoint import CheckpointManager, load_ensemble, load_model
from ..utils.wer import wer
from .train import Profiler, build_task, loader, parse_args

logger = logging.getLogger(__name__)


def main(cfg: TrainRootConfig, results_path: str = "results", device="cuda") -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO)
    with Profiler(cfg):
        return _main(cfg, results_path, device)


def load_constraints(path: str, tokenizer) -> Dict[int, List[List[int]]]:
    """Line N of ``path``: the tab-separated constraint phrases of manifest
    sample N, each tokenized without BOS."""
    out = {}
    with open(path) as f:
        for i, line in enumerate(f):
            phrases = [p for p in line.rstrip("\n").split("\t") if p.strip()]
            if phrases:
                out[i] = [tokenizer.encode(p, add_bos=False) for p in phrases]
    return out


def _main(cfg: TrainRootConfig, results_path: str, device) -> Dict[str, float]:
    task = build_task(cfg, device)
    ds = task.load_dataset("test")

    members = load_ensemble(CheckpointManager(cfg.checkpoint.save_dir),
                            cfg.checkpoint.restore_file, cfg.checkpoint.ensemble_mode,
                            strict=cfg.checkpoint.strict_ensemble, map_location="cpu")
    ensemble: List[AVSRSystem] = []
    if members is not None:
        load_model(task.module, members[0])
        for state in members[1:]:
            member = AVSRSystem(task.model_cfg, dtype=next(task.module.parameters()).dtype,
                                device=device)
            load_model(member.module, state)
            ensemble.append(member)
        logger.info("restored %s (%d member%s, mode=%s)", cfg.checkpoint.restore_file,
                    len(members), "s" if len(members) > 1 else "", cfg.checkpoint.ensemble_mode)
    else:
        logger.warning("no checkpoint found at %s: evaluating random weights (seed %d)",
                       cfg.checkpoint.save_dir, cfg.common.seed)
        task.init_random(cfg.common.seed)

    if cfg.generation.weight_quant:
        for system in (task.system, *ensemble):
            system.enable_quantized_decode(cfg.generation.weight_quant)
        logger.info("decoding with %s weight-only LLaMA", cfg.generation.weight_quant)

    constraints_by_id = None
    if cfg.generation.constraints_file:
        constraints_by_id = load_constraints(cfg.generation.constraints_file, ds.tokenizer)
        logger.info("constrained decoding (%s): %d/%d utterances constrained",
                    cfg.generation.constraints or "unordered", len(constraints_by_id), len(ds))

    hyps: List[str] = []
    refs: List[str] = []
    results = []
    batches = ds.batches(max_tokens=cfg.dataset.max_tokens, batch_size=cfg.dataset.batch_size)
    for raw in loader(cfg, ds, batches, device):
        batch = task.prepare_batch(to_device(raw, device), train=False)
        ids = raw["ids"].tolist()
        h, r = task.decode_to_text(batch, ids, ds, cfg.generation,
                                   constraints_by_id=constraints_by_id, ensemble=ensemble)
        for sample_id, hyp, ref in zip(ids, h, r):
            hyps.append(hyp)
            refs.append(ref)
            results.append({"id": int(sample_id), "hypo": hyp, "ref": ref})

    w, errs, words = wer(hyps, refs)
    os.makedirs(results_path, exist_ok=True)
    tag = hashlib.md5(json.dumps(vars(cfg.generation), default=str).encode()).hexdigest()[:8]
    with open(os.path.join(results_path, f"hypo-{tag}.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(results_path, f"wer.{tag}"), "w") as f:
        f.write(f"WER: {w:.4f}\nerr / num_ref_words = {errs} / {words}\n")
    logger.info("WER %.4f (%d/%d)", w, errs, words)
    return {"wer": w, "errors": errs, "words": words}


def cli_main(argv=None):
    cfg, args = parse_args(argv, results=True)
    main(cfg, args.results, device=args.device)


if __name__ == "__main__":
    cli_main()

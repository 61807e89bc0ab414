"""Import reference MMS-LLaMA product checkpoints into the port's AVSR modules.

Port of ``multimodalvc_tpu/interop/avsr_import.py``.  Reference checkpoints
store only the trainable weights (the frozen parameters are stripped): the
Q-Former (vendored BERT names), ``query_tokens``, ``afeat_1d_conv``, the
``avfeat_to_llm`` projector and the peft LoRA adapters.  The frozen
encoders load from their own artifacts: AV-HuBERT
(``nn/avhubert.py: import_torch_avhubert``), HF Whisper
(``nn/whisper.py: import_hf_whisper_encoder``), HF LLaMA
(``nn/llama.py: import_hf_llama``) and the speech-rate predictor
(``import_sr_predictor`` below).

Every importer returns a state dict in the port's layout (the module names
of ``interop/from_flax.py``; torch ``[out, in]`` weights, so a reference
linear or conv weight crosses as it is), and ``merge_state`` writes one
into a module.  LoRA ``lora_a`` [in, r] / ``lora_b`` [r, out] keep the flax
layout, as the bridge gives them.
"""
from __future__ import annotations

import logging
import re
from typing import List, Mapping, Optional, Union

import torch

from ..nn.state_maps import (
    StateDict,
    as_tensor,
    put_linear,
    put_norm,
    put_pos_conv,
    put_transformer_layers,
)

logger = logging.getLogger(__name__)


_LORA = re.compile(
    r"(?:.*\.)?layers\.(\d+)\.self_attn\.([qkvo]_proj)\.lora_([AB])(?:\.default)?\.weight$")


def import_reference_avsr(state: Mapping, num_qformer_layers: int = 2) -> StateDict:
    """A reference trainable-state dict as entries of ``AVSRModel``'s state
    dict (``encoder.*``, ``llama.*``), to merge over a built model."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    out: StateDict = {}

    # the 50 -> 25 Hz conv: torch [O, I, K] in both
    if "afeat_1d_conv.weight" in state:
        put_linear(out, state, "afeat_1d_conv", "encoder.afeat_1d_conv")

    # the Q-Former (vendored BLIP-2 BERT names)
    qf = "encoder.qformer"
    if "query_tokens" in state:
        out[f"{qf}.query_tokens"] = as_tensor(state["query_tokens"])
    if "Qformer.bert.embeddings.LayerNorm.weight" in state:
        put_norm(out, state, "Qformer.bert.embeddings.LayerNorm", f"{qf}.embeddings_ln")
    for i in range(num_qformer_layers):
        src, dst = f"Qformer.bert.encoder.layer.{i}", f"{qf}.layers_{i}"
        if f"{src}.attention.self.query.weight" not in state:
            continue
        for part, attn, ln in (("attention", "self_attn", "self_ln"),
                               ("crossattention", "cross_attn", "cross_ln")):
            for ref, ours in (("self.query", "q_proj"), ("self.key", "k_proj"),
                              ("self.value", "v_proj"), ("output.dense", "out_proj")):
                put_linear(out, state, f"{src}.{part}.{ref}", f"{dst}.{attn}.{ours}")
            put_norm(out, state, f"{src}.{part}.output.LayerNorm", f"{dst}.{ln}")
        put_linear(out, state, f"{src}.intermediate_query.dense", f"{dst}.intermediate_query")
        put_linear(out, state, f"{src}.output_query.dense", f"{dst}.output_query")
        put_norm(out, state, f"{src}.output_query.LayerNorm", f"{dst}.ffn_ln")

    # the projector to the LLaMA width
    if "avfeat_to_llm.layers.0.weight" in state:
        for j in (0, 1):
            put_linear(out, state, f"avfeat_to_llm.layers.{j}", f"encoder.avfeat_to_llm.layers_{j}")

    # peft LoRA adapters: ...self_attn.{q,k,v,o}_proj.lora_A(.default).weight
    for key, val in state.items():
        m = _LORA.match(key)
        if not m:
            continue
        layer, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        # torch A [r, in] -> lora_a [in, r]; B [out, r] -> lora_b [r, out]
        out[f"llama.layers_{layer}.self_attn.{proj}.lora_{ab.lower()}"] = \
            as_tensor(val).t().contiguous()
    return out


def import_sr_predictor(state: Mapping, num_layers: int = 2) -> StateDict:
    """The speech-rate predictor's checkpoint (keys with or without the
    ``sr_predictor.`` prefix) as ``nn/modules.py: SpeechRatePredictor``'s
    state dict; the weight-normed positional conv is folded."""
    state = {k.removeprefix("sr_predictor."): v for k, v in state.items()}
    out: StateDict = {"sr_token": as_tensor(state["sr_token"])}
    put_linear(out, state, "linear", "linear")
    put_linear(out, state, "sr_predictor", "sr_predictor")
    if "encoder.pos_conv.0.weight_v" in state:
        put_pos_conv(out, state, "encoder.pos_conv.0", "encoder.pos_conv.conv")
    put_norm(out, state, "encoder.layer_norm", "encoder.layer_norm")
    put_transformer_layers(out, state, "encoder", "encoder", num_layers)
    return out


def merge_state(target: Union[torch.nn.Module, StateDict], updates: Mapping,
                absent: Optional[List[str]] = None) -> int:
    """Write ``updates`` into ``target`` (a module, or a state dict whose
    tensors are written in place), each cast to the entry's dtype; returns
    the number of entries written.  A shape that differs raises; an entry
    the target lacks is logged by name, appended to ``absent`` when given,
    and not written (the JAX merge adds such leaves to its tree, where
    nothing reads them)."""
    own = target.state_dict() if isinstance(target, torch.nn.Module) else target
    n = 0
    lacking = []
    with torch.no_grad():
        for key, val in updates.items():
            if key not in own:
                lacking.append(key)
                continue
            val = as_tensor(val)
            if tuple(own[key].shape) != tuple(val.shape):
                raise ValueError(f"{key}: shape {tuple(own[key].shape)} != {tuple(val.shape)}")
            own[key].copy_(val)
            n += 1
    if lacking:
        logger.warning("merge_state: %d entries the target lacks, not written: %s",
                       len(lacking), ", ".join(lacking))
        if absent is not None:
            absent.extend(lacking)
    return n

"""Import reference speech-head weights into the port's speech modules.

Port of ``multimodalvc_tpu/interop/speech_import.py``: the ESPnet-lineage
Conformer that all three speech models use (``encoders.{i}`` with
``self_attn.linear_*``, ``feed_forward[_macaron].w_*``, ``conv_module.
{pointwise_cov1, depthwise_conv, norm, pointwise_cov2}`` (the vendored
module's spelling), ``norm_{ff,mha,ff_macaron,conv,final}`` and
``after_norm``), and the speech models' trainable heads (proj1 / proj2,
the mel head, the LayerNorms, the modality mask embeddings, and the E2E
model's weight-normed ``vocoder_*`` generator).
"""
from __future__ import annotations

from typing import Mapping

from ..nn.hifigan import import_torch_generator
from ..nn.state_maps import StateDict, as_tensor, put_batch_norm, put_linear, put_norm
from .avsr_import import import_reference_avsr


def import_torch_conformer(state: Mapping, num_blocks: int, prefix: str = "encoder.") -> StateDict:
    """A vendored-Conformer state dict as ``nn/conformer.py:
    ConformerEncoder``'s state dict, its BatchNorm running statistics
    included.  ``prefix`` locates the ESPnet ``Encoder`` in the checkpoint
    (``conformer.encoder.`` in a reference speech model).  The pointwise
    convs [O, I, 1] become the port's linears [O, I]; the depthwise conv
    [D, 1, K] crosses as it is."""
    out: StateDict = {}
    for i in range(num_blocks):
        src, dst = f"{prefix}encoders.{i}", f"blocks_{i}"
        for ref, ours in (("linear_q", "q_proj"), ("linear_k", "k_proj"),
                          ("linear_v", "v_proj"), ("linear_out", "out_proj")):
            put_linear(out, state, f"{src}.self_attn.{ref}", f"{dst}.self_attn.{ours}")
        for w in ("w_1", "w_2"):
            put_linear(out, state, f"{src}.feed_forward.{w}", f"{dst}.ff.{w}")
        put_norm(out, state, f"{src}.norm_mha", f"{dst}.norm_mha")
        put_norm(out, state, f"{src}.norm_ff", f"{dst}.norm_ff")
        if f"{src}.feed_forward_macaron.w_1.weight" in state:
            for w in ("w_1", "w_2"):
                put_linear(out, state, f"{src}.feed_forward_macaron.{w}", f"{dst}.ff_macaron.{w}")
            put_norm(out, state, f"{src}.norm_ff_macaron", f"{dst}.norm_ff_macaron")
        if f"{src}.conv_module.depthwise_conv.weight" in state:
            cm, ours = f"{src}.conv_module", f"{dst}.conv_module"
            for j in (1, 2):
                out[f"{ours}.pointwise_conv{j}.weight"] = \
                    as_tensor(state[f"{cm}.pointwise_cov{j}.weight"])[:, :, 0]
                out[f"{ours}.pointwise_conv{j}.bias"] = as_tensor(state[f"{cm}.pointwise_cov{j}.bias"])
            put_linear(out, state, f"{cm}.depthwise_conv", f"{ours}.depthwise_conv")
            put_batch_norm(out, state, f"{cm}.norm", f"{ours}.norm")
            put_norm(out, state, f"{src}.norm_conv", f"{dst}.norm_conv")
            put_norm(out, state, f"{src}.norm_final", f"{dst}.norm_final")
    if f"{prefix}after_norm.weight" in state:
        put_norm(out, state, f"{prefix}after_norm", "after_norm")
    return out


def import_reference_speech(state: Mapping, num_qformer_layers: int = 2,
                            conformer_blocks: int = 12, generator_cfg=None) -> StateDict:
    """A reference speech-model trainable checkpoint as a state dict of the
    port's speech modules: the AVSR trainables (``import_reference_avsr``:
    ``encoder.*``, LoRA under ``llama.*``), the modality mask embeddings,
    the head (``head.proj1`` / ``proj2`` / ``mel_head`` / ``ln1-3`` and
    ``head.conformer.*`` with its BatchNorm statistics) and, for the E2E
    model, the ``vocoder_*`` generator as ``generator.*``
    (``nn/hifigan.py: import_torch_generator`` with ``generator_cfg``).

    The keys fit ``SpeechLLMModel`` and ``SpeechNoLLMModel``; the E2E
    model holds the encoder and head under ``trunk.``, where its caller
    puts them, as the JAX caller nests them.  ``merge_state`` logs the
    entries a model lacks (the LoRA of a NoLLM model)."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    out = import_reference_avsr(state, num_qformer_layers)
    for emb in ("audio_mask_emb", "video_mask_emb"):
        if emb in state:
            out[f"encoder.{emb}"] = as_tensor(state[emb])
    if "proj1.weight" in state:
        put_linear(out, state, "proj1", "head.proj1")
        put_linear(out, state, "proj2", "head.proj2")
    if "mel_head.weight" in state:
        put_linear(out, state, "mel_head", "head.mel_head")
    for i in (1, 2, 3):
        if f"ln{i}.weight" in state:
            put_norm(out, state, f"ln{i}", f"head.ln{i}")
    if "conformer.encoder.encoders.0.self_attn.linear_q.weight" in state:
        conf = import_torch_conformer(state, conformer_blocks, prefix="conformer.encoder.")
        out.update({f"head.conformer.{k}": v for k, v in conf.items()})

    gen_state = {k[len("vocoder_"):]: as_tensor(v) for k, v in state.items()
                 if k.startswith("vocoder_")}
    if "conv_pre.weight_v" in gen_state:
        out.update({f"generator.{k}": v
                    for k, v in import_torch_generator(gen_state, generator_cfg).items()})
    return out

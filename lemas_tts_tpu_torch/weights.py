"""Carry weights across: JAX (flax) parameter trees -> this port's
``state_dict``s, and reference checkpoints -> the port.

The port's parameter names are the reference torch names
(``tests/torch_ref/dit_torch.py``, the published Vocos checkpoint), so the
mapping is the one ``lemas_tts_tpu/infer/checkpoints.py:export_dit_state_dict``
and the inverse of ``lemas_tts_tpu/models/vocos.py:convert_vocos`` apply:
Dense kernels ``[in, out]`` become Linear weights ``[out, in]``; Conv kernels
``[K, Cin/g, Cout]`` become ``[Cout, Cin/g, K]``; LayerNorm ``scale``/``bias``
become ``weight``/``bias``; the DiT's scan-stacked ``blocks`` (leading depth
axis) and the MMDiT's ``block_{i}`` become ``transformer_blocks.{i}``. Inputs
are nested dicts of numpy arrays (anything ``np.asarray`` takes).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    if "dit" in tree:
        tree = tree["dit"]
    return tree.get("params", tree)


class _StateDict(dict):
    def linear(self, key: str, node: Mapping[str, Any]) -> None:
        self[f"{key}.weight"] = _tensor(np.asarray(node["kernel"]).T)
        if "bias" in node:
            self[f"{key}.bias"] = _tensor(node["bias"])

    def conv(self, key: str, node: Mapping[str, Any]) -> None:
        self[f"{key}.weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
        if "bias" in node:
            self[f"{key}.bias"] = _tensor(node["bias"])

    def layer_norm(self, key: str, node: Mapping[str, Any]) -> None:
        self[f"{key}.weight"] = _tensor(node["scale"])
        self[f"{key}.bias"] = _tensor(node["bias"])

    def embeddings(self, p: Mapping[str, Any], conv_pos_key: str, conv_pos: Mapping[str, Any]):
        """The time MLP, the conv position embedding, the final AdaLN and
        the mel projection: the parts DiT and MMDiT share."""
        self.linear("time_embed.time_mlp.0", p["time_embed"]["mlp_in"])
        self.linear("time_embed.time_mlp.2", p["time_embed"]["mlp_out"])
        self.conv(f"{conv_pos_key}.conv1d.0", conv_pos["conv1"])
        self.conv(f"{conv_pos_key}.conv1d.2", conv_pos["conv2"])
        self.linear("norm_out.linear", p["norm_out"]["mod"])
        self.linear("proj_out", p["proj_out"])

    def feed_forward(self, key: str, node: Mapping[str, Any]) -> None:
        self.linear(f"{key}.ff.0.0", node["in_proj"])
        self.linear(f"{key}.ff.2", node["out_proj"])

    def qk_norms(self, key: str, node: Mapping[str, Any], names) -> None:
        for name in names:
            if name in node:
                self[f"{key}.{name}.weight"] = _tensor(node[name]["weight"])


def dit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiT`` params -> ``lemas_tts_tpu_torch.models.dit.DiT`` state dict."""
    p = _params(params)
    sd = _StateDict()
    sd.embeddings(p, "input_embed.conv_pos_embed", p["input_embed"]["conv_pos"])
    sd.linear("input_embed.proj", p["input_embed"]["proj"])

    te = p["text_embed"]
    sd["text_embed.text_embed.weight"] = _tensor(te["embed"]["embedding"])
    for name, node in te.items():
        if name.startswith("block_"):
            key = f"text_embed.text_blocks.{int(name.split('_')[1])}"
            sd.conv(f"{key}.dwconv", node["dwconv"])
            sd.layer_norm(f"{key}.norm", node["norm"])
            sd.linear(f"{key}.pwconv1", node["pwconv1"])
            sd[f"{key}.grn.gamma"] = _tensor(node["grn"]["gamma"])
            sd[f"{key}.grn.beta"] = _tensor(node["grn"]["beta"])
            sd.linear(f"{key}.pwconv2", node["pwconv2"])

    blocks = p["blocks"]["block"]
    if "kernel_q" in blocks.get("attn", {}).get("to_q", {}):
        raise ValueError("int8-quantized params cannot be carried over; use the float tree")
    depth = int(np.asarray(blocks["attn"]["to_q"]["kernel"]).shape[0])

    def layer(tree, i):
        if isinstance(tree, Mapping):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(depth):
        for k, v in dit_block_state_from_jax(layer(blocks, i)).items():
            sd[f"transformer_blocks.{i}.{k}"] = v
    for unported in ("long_skip", "prosody_text_proj"):
        if unported in p:
            raise NotImplementedError(f"{unported} is not ported yet")
    return dict(sd)


def dit_block_state_from_jax(blk: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One JAX ``DiTBlock``'s params -> ``DiTBlock`` state dict."""
    sd = _StateDict()
    sd.linear("attn_norm.linear", blk["attn_norm"]["mod"])
    for proj in ("to_q", "to_k", "to_v"):
        sd.linear(f"attn.{proj}", blk["attn"][proj])
    sd.linear("attn.to_out.0", blk["attn"]["to_out"])
    sd.feed_forward("ff", blk["ff"])
    sd.qk_norms("attn", blk["attn"], ("q_norm", "k_norm"))
    return dict(sd)


def mmdit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MMDiT`` params -> ``lemas_tts_tpu_torch.models.mmdit.MMDiT``
    state dict (the reference F5-TTS ``mmdit.py`` key names)."""
    p = _params(params)
    sd = _StateDict()
    sd.embeddings(p, "audio_embed.conv_pos_embed", p["audio_embed"]["conv_pos"])
    sd.linear("audio_embed.linear", p["audio_embed"]["linear"])
    sd["text_embed.text_embed.weight"] = _tensor(p["text_embed"]["embed"]["embedding"])
    i = 0
    while f"block_{i}" in p:
        blk, key = p[f"block_{i}"], f"transformer_blocks.{i}"
        sd.linear(f"{key}.attn_norm_x.linear", blk["attn_norm_x"]["mod"])
        sd.linear(f"{key}.attn_norm_c.linear", blk["attn_norm_c"]["mod"])
        attn = blk["attn"]
        for proj in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            sd.linear(f"{key}.attn.{proj}", attn[proj])
        sd.linear(f"{key}.attn.to_out.0", attn["to_out"])
        if "to_out_c" in attn:  # absent from the context-pre-only last block
            sd.linear(f"{key}.attn.to_out_c", attn["to_out_c"])
        sd.qk_norms(f"{key}.attn", attn, ("q_norm", "k_norm", "c_q_norm", "c_k_norm"))
        for ff in ("ff_x", "ff_c"):
            if ff in blk:
                sd.feed_forward(f"{key}.{ff}", blk[ff])
        i += 1
    return dict(sd)


def vocos_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Vocos`` params -> ``lemas_tts_tpu_torch.models.vocos.Vocos``
    state dict (the published checkpoint's key names)."""
    p = params.get("params", params)
    bb = p["backbone"]
    sd = _StateDict()
    sd.conv("backbone.embed", bb["embed"])
    sd.layer_norm("backbone.norm", bb["norm"])
    sd.layer_norm("backbone.final_layer_norm", bb["final_layer_norm"])
    i = 0
    while f"convnext_{i}" in bb:
        blk, key = bb[f"convnext_{i}"], f"backbone.convnext.{i}"
        sd.conv(f"{key}.dwconv", blk["dwconv"])
        sd.layer_norm(f"{key}.norm", blk["norm"])
        sd.linear(f"{key}.pwconv1", blk["pwconv1"])
        sd.linear(f"{key}.pwconv2", blk["pwconv2"])
        sd[f"{key}.gamma"] = _tensor(blk["gamma"])
        i += 1
    sd.linear("head.out", p["out"])
    return dict(sd)


def load_reference_state_dict(path: str, use_ema: bool = True,
                              prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """A reference CFM checkpoint (``.pt`` or ``.safetensors``) -> the DiT
    state dict: EMA or plain weights (``use_ema``, falling back to whichever
    exists) and the ``transformer.`` prefix stripped."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "ema_model_state_dict" in sd or "model_state_dict" in sd:
            first, second = (("ema_model_state_dict", "model_state_dict") if use_ema
                             else ("model_state_dict", "ema_model_state_dict"))
            sd = sd.get(first, sd.get(second))
    has_ema = any(k.startswith("ema_model.") for k in sd)
    has_plain = any(k.startswith(prefix) for k in sd)
    if has_ema and (use_ema or not has_plain):
        sd = {k[len("ema_model."):]: v for k, v in sd.items() if k.startswith("ema_model.")}
    return {k[len(prefix):]: v.float() for k, v in sd.items() if k.startswith(prefix)}

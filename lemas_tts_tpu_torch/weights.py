"""Carry weights across: JAX (flax) parameter trees -> this port's
``state_dict``s, and reference checkpoints -> the port.

The port's parameter names are the reference torch names
(``tests/torch_ref/dit_torch.py``, the published Vocos checkpoint), so the
mapping is the one ``lemas_tts_tpu/infer/checkpoints.py:export_dit_state_dict``
and the inverse of ``lemas_tts_tpu/models/vocos.py:convert_vocos`` apply:
Dense kernels ``[in, out]`` become Linear weights ``[out, in]``; Conv kernels
``[K, Cin/g, Cout]`` become ``[Cout, Cin/g, K]``; LayerNorm ``scale``/``bias``
become ``weight``/``bias``; the DiT's scan-stacked ``blocks`` (leading depth
axis) and the MMDiT's ``block_{i}`` become ``transformer_blocks.{i}``, the
UNetT's ``*_{i}`` layers ``layers.{i}.{0-4}``. Inputs are nested dicts of
numpy arrays (anything ``np.asarray`` takes).

Reference checkpoints: the CFM file's backbone (the DiT's
``prosody_text_proj`` and ``long_skip_connection`` included) and its
``prosody_to_mel`` (``load_reference_checkpoint``), the
Pretssel prosody encoder (``load_prosody_checkpoint``) and NVIDIA's BigVGAN
generator with its weight norm folded (``load_bigvgan_checkpoint``).

Training state: the accent and CTC heads (``accent_state_from_jax``,
``ctc_state_from_jax``), the speaker encoder with its BatchNorm statistics
(``speaker_state_from_jax``) and a whole JAX ``TrainState.params``
(``train_params_from_jax``).

UVR5: the JAX MDX ``ConvTDFNet`` and ``Mixer`` params and the VR nets'
variables become the reference's state dicts (``mdx_state_from_jax``,
``mixer_state_from_jax``, ``cascadednet_state_from_jax``,
``cascaded_aspp_state_from_jax``), the inverses of the JAX package's
``convert_*`` functions.
"""

from __future__ import annotations

from pathlib import Path
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
        """The time MLP, the conv position embedding and the mel projection:
        the parts DiT, MMDiT and UNetT share."""
        self.linear("time_embed.time_mlp.0", p["time_embed"]["mlp_in"])
        self.linear("time_embed.time_mlp.2", p["time_embed"]["mlp_out"])
        self.conv(f"{conv_pos_key}.conv1d.0", conv_pos["conv1"])
        self.conv(f"{conv_pos_key}.conv1d.2", conv_pos["conv2"])
        self.linear("proj_out", p["proj_out"])

    def feed_forward(self, key: str, node: Mapping[str, Any]) -> None:
        self.linear(f"{key}.ff.0.0", node["in_proj"])
        self.linear(f"{key}.ff.2", node["out_proj"])

    def qk_norms(self, key: str, node: Mapping[str, Any], names) -> None:
        for name in names:
            if name in node:
                self[f"{key}.{name}.weight"] = _tensor(node[name]["weight"])

    def text_embedding(self, te: Mapping[str, Any]) -> None:
        """The DiT/UNetT ``TextEmbedding``: the table and its ConvNeXt stack."""
        self["text_embed.text_embed.weight"] = _tensor(te["embed"]["embedding"])
        for name, node in te.items():
            if name.startswith("block_"):
                key = f"text_embed.text_blocks.{int(name.split('_')[1])}"
                self.conv(f"{key}.dwconv", node["dwconv"])
                self.layer_norm(f"{key}.norm", node["norm"])
                self.linear(f"{key}.pwconv1", node["pwconv1"])
                self[f"{key}.grn.gamma"] = _tensor(node["grn"]["gamma"])
                self[f"{key}.grn.beta"] = _tensor(node["grn"]["beta"])
                self.linear(f"{key}.pwconv2", node["pwconv2"])

    def attention(self, key: str, node: Mapping[str, Any]) -> None:
        for proj in ("to_q", "to_k", "to_v"):
            self.linear(f"{key}.{proj}", node[proj])
        self.linear(f"{key}.to_out.0", node["to_out"])
        self.qk_norms(key, node, ("q_norm", "k_norm"))


def dit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiT`` params -> ``lemas_tts_tpu_torch.models.dit.DiT`` state dict."""
    p = _params(params)
    sd = _StateDict()
    sd.embeddings(p, "input_embed.conv_pos_embed", p["input_embed"]["conv_pos"])
    sd.linear("norm_out.linear", p["norm_out"]["mod"])
    sd.linear("input_embed.proj", p["input_embed"]["proj"])
    sd.text_embedding(p["text_embed"])

    blocks = p["blocks"]["block"]
    refuse_quantized(blocks)
    depth = int(np.asarray(blocks["attn"]["to_q"]["kernel"]).shape[0])

    def layer(tree, i):
        if isinstance(tree, Mapping):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(depth):
        for k, v in dit_block_state_from_jax(layer(blocks, i)).items():
            sd[f"transformer_blocks.{i}.{k}"] = v
    if "long_skip" in p:
        sd.linear("long_skip_connection", p["long_skip"])
    if "prosody_text_proj" in p:
        sd.linear("prosody_text_proj", p["prosody_text_proj"])
    return dict(sd)


def refuse_quantized(tree: Mapping[str, Any]) -> None:
    """``ValueError`` for an int8 tree (``kernel_q`` leaves, the JAX
    package's ``quantize_dense_tree``): the port quantizes float weights as
    they load, so it takes the float checkpoint."""
    from lemas_tts_tpu_torch.infer.checkpoints import has_quantized_leaves

    if has_quantized_leaves(tree):
        raise ValueError("int8-quantized params (kernel_q leaves) cannot be loaded into the "
                         "port: load the float checkpoint the quantized tree was converted "
                         "from, with TTS(quantization=...) to quantize it as it loads")


def dit_block_state_from_jax(blk: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One JAX ``DiTBlock``'s params -> ``DiTBlock`` state dict."""
    sd = _StateDict()
    sd.linear("attn_norm.linear", blk["attn_norm"]["mod"])
    sd.attention("attn", blk["attn"])
    sd.feed_forward("ff", blk["ff"])
    return dict(sd)


def unett_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNetT`` params -> ``lemas_tts_tpu_torch.models.unett.UNetT``
    state dict (the reference F5-TTS ``unett.py`` key names)."""
    p = _params(params)
    sd = _StateDict()
    sd.embeddings(p, "input_embed.conv_pos_embed", p["input_embed"]["conv_pos"])
    sd["norm_out.weight"] = _tensor(p["norm_out"]["weight"])  # RMSNorm, not AdaLN
    sd.linear("input_embed.proj", p["input_embed"]["proj"])
    sd.text_embedding(p["text_embed"])
    i = 0
    while f"attn_{i}" in p:
        key = f"layers.{i}"
        if f"skip_proj_{i}" in p:
            sd.linear(f"{key}.0", p[f"skip_proj_{i}"])
        sd[f"{key}.1.weight"] = _tensor(p[f"attn_norm_{i}"]["weight"])
        sd.attention(f"{key}.2", p[f"attn_{i}"])
        sd[f"{key}.3.weight"] = _tensor(p[f"ff_norm_{i}"]["weight"])
        sd.feed_forward(f"{key}.4", p[f"ff_{i}"])
        i += 1
    return dict(sd)


def prosody_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ECAPA_TDNN`` params -> ``lemas_tts_tpu_torch.models.prosody.ECAPA_TDNN``
    state dict (the reference key names; the inverse of the JAX
    ``convert_prosody_encoder``)."""
    p = params.get("params", params)
    sd = _StateDict()

    def tdnn(key, node):
        sd.conv(f"{key}.conv", node["conv"])
        sd.layer_norm(f"{key}.norm", node["norm"])

    tdnn("blocks.0", p["block_0"])
    i = 1
    while f"block_{i}" in p:
        blk, key = p[f"block_{i}"], f"blocks.{i}"
        tdnn(f"{key}.tdnn1", blk["tdnn1"])
        tdnn(f"{key}.tdnn2", blk["tdnn2"])
        sd.conv(f"{key}.se_block.conv1", blk["se"]["conv1"])
        sd.conv(f"{key}.se_block.conv2", blk["se"]["conv2"])
        for name, node in blk["res2net"].items():
            tdnn(f"{key}.res2net_block.blocks.{int(name.split('_')[1])}", node)
        if "shortcut" in blk:
            sd.conv(f"{key}.shortcut", blk["shortcut"])
        i += 1
    tdnn("mfa", p["mfa"])
    tdnn("asp.tdnn", p["asp"]["tdnn"])
    sd.conv("asp.conv", p["asp"]["conv"])
    sd.layer_norm("asp_norm", p["asp_norm"])
    sd.conv("fc", p["fc"])
    return dict(sd)


def prosody_to_mel_from_jax(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``prosody_to_mel`` Dense (``{"kernel": [512, D], "bias"}``) ->
    a ``Linear(512, D)`` state dict."""
    return {"weight": _tensor(np.asarray(node["kernel"]).T), "bias": _tensor(node["bias"])}


def accent_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``AccentClassifier`` params -> ``cfm.loss.AccentClassifier`` state dict."""
    p = params.get("params", params)
    sd = _StateDict()
    sd.linear("fc1", p["fc1"])
    sd.linear("fc2", p["fc2"])
    return dict(sd)


def ctc_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CTCHead`` params -> ``cfm.loss.CTCHead`` state dict (the
    reference's ``proj.0`` / ``ctc_proj`` names)."""
    p = params.get("params", params)
    sd = _StateDict()
    sd.linear("proj.0", p["proj"])
    sd.linear("ctc_proj", p["ctc_proj"])
    return dict(sd)


def speaker_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SpeakerEncoder`` variables (``params`` and ``batch_stats``) ->
    ``models.speaker.SpeakerEncoder`` state dict."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, node):
        sd[f"{key}.conv.weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
        sd[f"{key}.conv.bias"] = _tensor(node["bias"])

    def bn(key, node, st):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _tensor(node["scale"]), _tensor(node["bias"])
        sd[f"{key}.running_mean"] = _tensor(st["mean"])
        sd[f"{key}.running_var"] = _tensor(st["var"])

    def tdnn(key, node, st):
        conv(f"{key}.conv", node["conv"])
        bn(f"{key}.bn", node["bn"], st["bn"])

    tdnn("blocks.0", p["block_0"], stats["block_0"])
    i = 1
    while f"block_{i}" in p:
        blk, st, key = p[f"block_{i}"], stats[f"block_{i}"], f"blocks.{i}"
        tdnn(f"{key}.tdnn1", blk["tdnn1"], st["tdnn1"])
        tdnn(f"{key}.tdnn2", blk["tdnn2"], st["tdnn2"])
        for name, node in blk["res2net"].items():
            tdnn(f"{key}.res2net.blocks.{int(name.split('_')[1])}", node,
                 st["res2net"][name])
        conv(f"{key}.se.conv1", blk["se"]["conv1"])
        conv(f"{key}.se.conv2", blk["se"]["conv2"])
        if "shortcut" in blk:
            conv(f"{key}.shortcut", blk["shortcut"])
        i += 1
    tdnn("mfa", p["mfa"], stats["mfa"])
    tdnn("asp_tdnn", p["asp_tdnn"], stats["asp_tdnn"])
    conv("asp_conv", p["asp_conv"])
    bn("asp_bn", p["asp_bn"], stats["asp_bn"])
    sd["fc.weight"] = _tensor(np.asarray(p["fc"]["kernel"]).T)
    sd["fc.bias"] = _tensor(p["fc"]["bias"])
    return sd


def train_params_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``TrainState.params`` (``{"dit", "accent", "ctc"?,
    "prosody_to_mel"?}``) -> state dicts of the port's ``Trainer`` modules,
    by the same names."""
    out = {"dit": dit_state_from_jax(params["dit"]),
           "accent": accent_state_from_jax(params["accent"])}
    if "ctc" in params:
        out["ctc"] = ctc_state_from_jax(params["ctc"])
    if "prosody_to_mel" in params:
        out["prosody_to_mel"] = prosody_to_mel_from_jax(params["prosody_to_mel"])
    return out


def bigvgan_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``BigVGAN`` params -> ``lemas_tts_tpu_torch.models.bigvgan.BigVGAN``
    state dict (NVIDIA's key names, weight norm folded)."""
    p = params.get("params", params)
    sd = _StateDict()

    def act(key, node):
        for name in ("alpha", "beta"):
            if name in node:
                sd[f"{key}.act.{name}"] = _tensor(node[name])

    sd.conv("conv_pre", p["conv_pre"])
    sd.conv("conv_post", p["conv_post"])
    act("activation_post", p["act_post"])
    n_res = sum(1 for name in p if name.startswith("res_0_"))
    i = 0
    while f"up_{i}" in p:
        # a transposed conv's [K, Cout, Cin] kernel -> torch [Cin, Cout, K]
        sd.conv(f"ups.{i}.0", p[f"up_{i}"])
        for j in range(n_res):
            blk, key = p[f"res_{i}_{j}"], f"resblocks.{i * n_res + j}"
            d = 0
            while f"conv1_{d}" in blk:
                sd.conv(f"{key}.convs1.{d}", blk[f"conv1_{d}"])
                sd.conv(f"{key}.convs2.{d}", blk[f"conv2_{d}"])
                act(f"{key}.activations.{2 * d}", blk[f"act1_{d}"])
                act(f"{key}.activations.{2 * d + 1}", blk[f"act2_{d}"])
                d += 1
        i += 1
    return dict(sd)


def mmdit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MMDiT`` params -> ``lemas_tts_tpu_torch.models.mmdit.MMDiT``
    state dict (the reference F5-TTS ``mmdit.py`` key names)."""
    p = _params(params)
    sd = _StateDict()
    sd.embeddings(p, "audio_embed.conv_pos_embed", p["audio_embed"]["conv_pos"])
    sd.linear("norm_out.linear", p["norm_out"]["mod"])
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


def checkpoint_file(path) -> Path:
    """A checkpoint given as a file or a directory, as a file: a directory
    gives its ``model.pt`` (a distillation stage), else ``model_last.pt``
    (a training run), else its newest ``model_<step>.pt``."""
    p = Path(path)
    if not p.is_dir():
        return p
    for name in ("model.pt", "model_last.pt"):
        if (p / name).is_file():
            return p / name
    snaps = sorted((int(f.stem.split("_")[1]), f) for f in p.glob("model_*.pt")
                   if f.stem.split("_")[1].isdigit())
    if not snaps:
        raise FileNotFoundError(f"no checkpoint file in {p}")
    return snaps[-1][1]


def load_torch_file(path: str, use_ema: bool = True) -> Dict[str, Any]:
    """A ``.safetensors`` or torch (``.pt``/``.ckpt``/``.pth``) file -> its
    dict; of a training file's ``ema_model_state_dict`` and
    ``model_state_dict``, the one ``use_ema`` picks, else the other."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(str(path)))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "ema_model_state_dict" in obj or "model_state_dict" in obj:
        first, second = (("ema_model_state_dict", "model_state_dict") if use_ema
                         else ("model_state_dict", "ema_model_state_dict"))
        obj = obj.get(first, obj.get(second))
    return obj


def select_stream(sd: Mapping[str, Any], use_ema: bool = True) -> Dict[str, Any]:
    """The weights a reference CFM state dict loads as, the port's one rule:
    ``use_ema`` takes the ``ema_model.`` stream with that prefix stripped,
    and so does a file with no plain backbone (no ``transformer.`` key);
    else the plain stream. The EMA's ``initted`` and ``step`` are dropped."""
    has_ema = any(k.startswith("ema_model.") for k in sd)
    has_plain = any(k.startswith("transformer.") for k in sd)
    take_ema = has_ema and (use_ema or not has_plain)
    out = {}
    for k, v in sd.items():
        if k.startswith("ema_model.") != take_ema:
            continue
        k = k[len("ema_model."):] if take_ema else k
        if k not in ("initted", "step"):
            out[k] = v
    return out


def load_reference_checkpoint(path: str, use_ema: bool = True):
    """A reference CFM checkpoint (``.pt`` or ``.safetensors``) -> (the
    backbone's state dict, its ``prosody_to_mel`` Linear's state dict or None
    when it has none), f32: the weights :func:`select_stream` picks, with
    ``transformer.`` stripped."""
    sd = select_stream(load_torch_file(path, use_ema=use_ema), use_ema)
    prefix = "transformer."
    backbone = {k[len(prefix):]: v.float() for k, v in sd.items() if k.startswith(prefix)}
    to_mel = ({k: sd[f"prosody_to_mel.{k}"].float() for k in ("weight", "bias")}
              if "prosody_to_mel.weight" in sd else None)
    return backbone, to_mel


def load_prosody_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The Pretssel prosody encoder's checkpoint (``prosody_encoder_UnitY2.pt``)
    -> an ``ECAPA_TDNN`` state dict (prefixes stripped, f32)."""
    from lemas_tts_tpu_torch.models.prosody import remap_prosody_state_dict

    return {k: v.float() for k, v in remap_prosody_state_dict(load_torch_file(path)).items()}


def fold_weight_norm(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every weight-normed pair ``{p}.weight_g`` / ``{p}.weight_v`` into
    ``{p}.weight = g * v / ||v||``, the norm over all but the first axis
    (torch ``weight_norm(dim=0)``), clamped at 1e-12."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_v"):
            p = k[: -len(".weight_v")]
            v = v.double()
            norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.dim())), keepdim=True))
            out[f"{p}.weight"] = (sd[f"{p}.weight_g"].double() * v
                                  / torch.clamp(norm, min=1e-12)).float()
        elif not k.endswith(".weight_g"):
            out[k] = v.float()
    return out


def find_bigvgan_checkpoint(path):
    """NVIDIA's BigVGAN generator file in directory ``path`` (``bigvgan_generator.pt``,
    ``pytorch_model.bin`` or ``g_05000000``), ``path`` itself if it is a file,
    else None."""
    p = Path(path)
    return next((q for q in (p / "bigvgan_generator.pt", p / "pytorch_model.bin",
                             p / "g_05000000", p) if q.is_file()), None)


def load_bigvgan_checkpoint(path) -> Dict[str, torch.Tensor]:
    """NVIDIA's BigVGAN generator file -> a ``BigVGAN`` state dict with the
    weight norm folded; the alias-free filters it stores are dropped (the
    port makes its own taps)."""
    sd = load_torch_file(str(path))
    if isinstance(sd.get("generator"), Mapping):
        sd = sd["generator"]
    if any(k.startswith("generator.") for k in sd):
        sd = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
    return {k: v for k, v in fold_weight_norm(sd).items() if not k.endswith(".filter")}


# ------------------------------------------------------------------- UVR5
def _conv2d(sd: Dict[str, torch.Tensor], key: str, node: Mapping[str, Any]) -> None:
    """flax ``Conv``/``ConvTranspose(transpose_kernel=True)`` kernel
    ``[kh, kw, a, b]`` -> torch ``[b, a, kh, kw]`` (the inverse of the JAX
    package's ``_conv2d``/``_convT2d``, which share the permutation)."""
    sd[f"{key}.weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{key}.bias"] = _tensor(node["bias"])


def _batch_norm(sd: Dict[str, torch.Tensor], key: str, scale, bias, mean, var) -> None:
    sd[f"{key}.weight"], sd[f"{key}.bias"] = _tensor(scale), _tensor(bias)
    sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = _tensor(mean), _tensor(var)
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _mdx_norm(sd: Dict[str, torch.Tensor], key: str, node: Mapping[str, Any]) -> None:
    """``GroupNorm`` (``gn``) -> ``.weight``/``.bias``; the folded affine of
    ``norm="affine"`` -> an eval-mode ``BatchNorm2d`` that computes it
    (mean 0, variance 1 - eps)."""
    if "gn" in node:
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _tensor(node["gn"]["scale"]), _tensor(
            node["gn"]["bias"])
        return
    c = np.asarray(node["scale"]).shape[0]
    _batch_norm(sd, key, node["scale"], node["bias"], np.zeros(c), np.full(c, 1.0 - 1e-5))


def _tfc_tdf(sd: Dict[str, torch.Tensor], key: str, node: Mapping[str, Any]) -> None:
    tfc, tdf = node["tfc"], node["tdf"]
    j = 0
    while f"conv_{j}" in tfc:
        _conv2d(sd, f"{key}.tfc.H.{j}.0", tfc[f"conv_{j}"])
        _mdx_norm(sd, f"{key}.tfc.H.{j}.1", tfc[f"norm_{j}"])
        j += 1
    for lin, norm, idx in (("lin0", "norm_0", 0), ("lin1", "norm_1", 3)):
        if f"{lin}_w" in tdf:
            sd[f"{key}.tdf.{idx}.weight"] = _tensor(np.asarray(tdf[f"{lin}_w"]).T)
            if f"{lin}_b" in tdf:
                sd[f"{key}.tdf.{idx}.bias"] = _tensor(tdf[f"{lin}_b"])
            _mdx_norm(sd, f"{key}.tdf.{idx + 1}", tdf[norm])


def mdx_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ConvTDFNet`` params -> ``uvr5.mdxnet.ConvTDFNet`` state dict
    (the reference names: the inverse of ``convert_convtdfnet``)."""
    p = _params(params)
    sd: Dict[str, torch.Tensor] = {}
    _conv2d(sd, "first_conv.0", p["first_conv"])
    _mdx_norm(sd, "first_conv.1", p["first_norm"])
    i = 0
    while f"enc_{i}" in p:
        _tfc_tdf(sd, f"encoding_blocks.{i}", p[f"enc_{i}"])
        _conv2d(sd, f"ds.{i}.0", p[f"ds_conv_{i}"])
        _mdx_norm(sd, f"ds.{i}.1", p[f"ds_norm_{i}"])
        _conv2d(sd, f"us.{i}.0", p[f"us_conv_{i}"])
        _mdx_norm(sd, f"us.{i}.1", p[f"us_norm_{i}"])
        _tfc_tdf(sd, f"decoding_blocks.{i}", p[f"dec_{i}"])
        i += 1
    _tfc_tdf(sd, "bottleneck_block", p["bottleneck"])
    _conv2d(sd, "final_conv.0", p["final_conv"])
    return sd


def mixer_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Mixer`` params -> ``uvr5.mdxnet.Mixer`` state dict."""
    return {"linear.weight": _tensor(np.asarray(_params(params)["linear"]["kernel"]).T)}


class _VRState(dict):
    """The VR nets' params and batch statistics (``{"params", "batch_stats"}``)
    -> the reference's names."""

    def conv_bn(self, key: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        """``ConvBNActiv`` -> ``{key}.conv.0`` (conv) / ``{key}.conv.1`` (BN)."""
        self.conv_bn_pair(f"{key}.conv.0", f"{key}.conv.1", p["conv"], p["bn"], s["bn"])

    def conv_bn_pair(self, conv_key: str, bn_key: str, conv, bn, stats) -> None:
        _conv2d(self, conv_key, conv)
        _batch_norm(self, bn_key, bn["scale"], bn["bias"], stats["mean"], stats["var"])

    def lstm(self, key: str, fwd: Mapping[str, Any], bwd: Mapping[str, Any]) -> None:
        """Two flax ``OptimizedLSTMCell``s (per-gate Dense, the input side
        bias-free) -> one bidirectional ``nn.LSTM`` (gates stacked i, f, g,
        o; the hidden side's bias as ``bias_hh``, ``bias_ih`` zero)."""
        for sfx, cell in (("", fwd), ("_reverse", bwd)):
            gates = "ifgo"
            self[f"{key}.weight_ih_l0{sfx}"] = _tensor(np.concatenate(
                [np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates]))
            self[f"{key}.weight_hh_l0{sfx}"] = _tensor(np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates]))
            b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
            self[f"{key}.bias_ih_l0{sfx}"] = _tensor(np.zeros_like(b))
            self[f"{key}.bias_hh_l0{sfx}"] = _tensor(b)

    def base_net(self, key: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        """One new-arch ``BaseNet`` stage."""
        self.conv_bn(f"{key}.enc1", p["enc1"], s["enc1"])
        for enc in ("enc2", "enc3", "enc4", "enc5"):
            for c in ("conv1", "conv2"):
                self.conv_bn(f"{key}.{enc}.{c}", p[enc][c], s[enc][c])
        a, sa = p["aspp"], s["aspp"]
        self.conv_bn(f"{key}.aspp.conv1.1", a["conv1"], sa["conv1"])
        self.conv_bn(f"{key}.aspp.conv2", a["conv2"], sa["conv2"])
        for i in (3, 4, 5):
            self.conv_bn_pair(f"{key}.aspp.conv{i}.conv.0", f"{key}.aspp.conv{i}.conv.1",
                              a[f"conv{i}_conv"], a[f"conv{i}_bn"], sa[f"conv{i}_bn"])
        self.conv_bn(f"{key}.aspp.bottleneck", a["bottleneck"], sa["bottleneck"])
        for dec in ("dec4", "dec3", "dec2", "dec1"):
            self.conv_bn(f"{key}.{dec}.conv1", p[dec]["conv1"], s[dec]["conv1"])
        m, sm = p["lstm_dec2"], s["lstm_dec2"]
        self.conv_bn(f"{key}.lstm_dec2.conv", m["conv"], sm["conv"])
        self.lstm(f"{key}.lstm_dec2.lstm", m["OptimizedLSTMCell_0"], m["OptimizedLSTMCell_1"])
        self.linear_bn(f"{key}.lstm_dec2.dense", m["dense"], m["dense_bn"], sm["dense_bn"])

    def linear_bn(self, key: str, dense, bn, stats) -> None:
        self[f"{key}.0.weight"] = _tensor(np.asarray(dense["kernel"]).T)
        self[f"{key}.0.bias"] = _tensor(dense["bias"])
        _batch_norm(self, f"{key}.1", bn["scale"], bn["bias"], stats["mean"], stats["var"])

    def base_aspp_net(self, key: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        """One legacy ``BaseASPPNet``: its stages and ASPP branches are the
        ones its params hold."""
        for name in ("enc1", "enc2", "enc3", "enc4", "enc5"):
            if name in p:
                for c in ("conv1", "conv2"):
                    self.conv_bn(f"{key}.{name}.{c}", p[name][c], s[name][c])
        for name in ("dec5", "dec4", "dec3", "dec2", "dec1"):
            if name in p:
                self.conv_bn(f"{key}.{name}.conv", p[name]["conv"], s[name]["conv"])
        a, sa = p["aspp"], s["aspp"]
        self.conv_bn(f"{key}.aspp.conv1.1", a["conv1"], sa["conv1"])
        self.conv_bn(f"{key}.aspp.conv2", a["conv2"], sa["conv2"])
        i = 3
        while f"conv{i}" in a:
            b, sb = a[f"conv{i}"], sa[f"conv{i}"]
            _conv2d(self, f"{key}.aspp.conv{i}.conv.0", b["depthwise"])
            _conv2d(self, f"{key}.aspp.conv{i}.conv.1", b["pointwise"])
            _batch_norm(self, f"{key}.aspp.conv{i}.conv.2", b["bn"]["scale"], b["bn"]["bias"],
                        sb["bn"]["mean"], sb["bn"]["var"])
            i += 1
        self.conv_bn(f"{key}.aspp.bottleneck.0", a["bottleneck"], sa["bottleneck"])

    def zero_conv(self, key: str, nin: int) -> None:
        """A training-only 1×1 head the JAX package drops: zeros, never run."""
        self[f"{key}.weight"] = torch.zeros(2, nin, 1, 1)


def cascadednet_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CascadedNet`` variables (``params`` + ``batch_stats``) ->
    ``uvr5.vr_network.CascadedNet`` state dict (the inverse of
    ``convert_cascadednet``; the training-only ``aux_out`` head, which the
    JAX net lacks, is zero)."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _VRState()
    sd.base_net("stg1_low_band_net.0", p["stg1_low"], s["stg1_low"])
    sd.conv_bn("stg1_low_band_net.1", p["stg1_low_out"], s["stg1_low_out"])
    sd.base_net("stg1_high_band_net", p["stg1_high"], s["stg1_high"])
    sd.base_net("stg2_low_band_net.0", p["stg2_low"], s["stg2_low"])
    sd.conv_bn("stg2_low_band_net.1", p["stg2_low_out"], s["stg2_low_out"])
    sd.base_net("stg2_high_band_net", p["stg2_high"], s["stg2_high"])
    sd.base_net("stg3_full_band_net", p["stg3_full"], s["stg3_full"])
    _conv2d(sd, "out", p["out"])
    nout = sd["out.weight"].shape[1]
    sd.zero_conv("aux_out", 3 * nout // 4)
    return dict(sd)


def cascaded_aspp_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CascadedASPPNet`` variables -> ``uvr5.vr_legacy.CascadedASPPNet``
    state dict (the inverse of ``convert_cascaded_aspp``; the training-only
    ``aux1_out``/``aux2_out`` heads are zero). ``vr_legacy.infer_architecture``
    of the result gives the ``nn_architecture`` to build."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _VRState()
    for ours, theirs in (("stg1_low", "stg1_low_band_net"), ("stg1_high", "stg1_high_band_net"),
                         ("stg2_full", "stg2_full_band_net"),
                         ("stg3_full", "stg3_full_band_net")):
        sd.base_aspp_net(theirs, p[ours], s[ours])
    sd.conv_bn("stg2_bridge", p["stg2_bridge"], s["stg2_bridge"])
    sd.conv_bn("stg3_bridge", p["stg3_bridge"], s["stg3_bridge"])
    _conv2d(sd, "out", p["out"])
    ch = sd["stg1_low_band_net.enc1.conv1.conv.0.weight"].shape[0]
    sd.zero_conv("aux1_out", ch)
    sd.zero_conv("aux2_out", ch)
    return dict(sd)

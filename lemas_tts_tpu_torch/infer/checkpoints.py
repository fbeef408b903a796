"""Checkpoint loading and conversion (counterpart of
``lemas_tts_tpu/infer/checkpoints.py``), without JAX or orbax.

 - ``load_state_dict`` / ``normalize_state_dict``: a reference
   ``.safetensors``/``.pt`` file as numpy, the EMA remap and the back-compat
   deletions of the reference loader (``utils_infer.py:204-246``), on
   ``weights.py``'s reader and EMA rule (``load_torch_file``,
   ``select_stream``), which ``TTS`` loads with too. One delta from JAX: the
   JAX function counts any key outside ``ema_model.`` as a plain stream, the
   port only ``transformer.`` keys, so with ``use_ema=False`` a file whose
   plain keys hold no backbone gives its EMA stream (JAX: a tree without
   one);
 - ``convert_dit`` / ``convert_cfm``: the reference layout -> the JAX
   package's param tree (Dense ``[in, out]``, Conv ``[k, in/g, out]``, the
   DiT blocks stacked on axis 0), numpy, leaf for leaf what the JAX
   functions give; ``export_dit_state_dict`` is their exact inverse;
 - ``load_cfm_checkpoint``: a reference file or a native directory -> the
   state dicts of the port's modules (``{"dit": ..., "prosody_to_mel":
   ...}``), what ``TTS`` and the probes load;
 - ``save_native`` / ``load_native``: the JAX package's native checkpoints,
   orbax ``StandardCheckpointer`` directories, written and read with
   ``tensorstore``: ``_METADATA`` holds each leaf's key path, an OCDBT
   key-value store one zarr array per leaf under the key
   ``<k1>.<k2>...`` (zarr v2, or zarr3 where ``_METADATA`` says
   ``use_zarr3``). ``load_native`` gives the nested tree JAX's
   ``load_native`` restores, with numpy arrays where it gives ``jax.Array``s;
   JAX's ``load_native`` restores what ``save_native`` writes.

``tensorstore`` is an optional dependency, imported inside the two native
functions; without it they raise ``ImportError`` naming it. An int8 tree
(``kernel_q`` leaves, JAX's ``quantize_dense_tree``) is refused by the
carry-over functions (``weights.py``) with ``ValueError``: the port
quantizes float weights as they load (``TTS(quantization=...)``).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Back-compat keys deleted by the reference loader (utils_infer.py:233-235).
_BACKCOMPAT_DELETE = (
    "mel_spec.mel_stft.mel_scale.fb",
    "mel_spec.mel_stft.spectrogram.window",
    "ctc.proj.0.weight",
    "ctc.proj.0.bias",
    "ctc.ctc_proj.weight",
    "ctc.ctc_proj.bias",
)


def _to_numpy(v, keep_dtype: bool) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if keep_dtype and v.dtype != torch.bfloat16:  # numpy has no bfloat16
        return v.detach().cpu().numpy()
    return v.detach().cpu().float().numpy()


def load_state_dict(path: str, use_ema: bool = True) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` or torch ``.pt`` file -> {key: np.ndarray}
    (``weights.load_torch_file``): of a training file's
    ``ema_model_state_dict`` and ``model_state_dict``, the one ``use_ema``
    picks, else the other. A torch file's tensors come as f32, a
    ``.safetensors`` file's in their own dtype (bfloat16 as f32), as in
    the JAX function."""
    from lemas_tts_tpu_torch.weights import load_torch_file

    keep = str(path).endswith(".safetensors")
    return {k: _to_numpy(v, keep) for k, v in load_torch_file(path, use_ema=use_ema).items()}


def normalize_state_dict(sd: Mapping[str, np.ndarray],
                         use_ema: bool = True) -> Dict[str, np.ndarray]:
    """The stream ``weights.select_stream`` picks (``use_ema`` takes the
    ``ema_model.`` one; a file without plain ``transformer.`` keys gives its
    EMA stream either way), then the reference loader's back-compat
    deletions."""
    from lemas_tts_tpu_torch.weights import select_stream

    out = {k: np.asarray(v) for k, v in select_stream(sd, use_ema).items()}
    for k in _BACKCOMPAT_DELETE:
        out.pop(k, None)
    return out


# ----------------------------------------------------- reference -> JAX layout
def _linear(sd, prefix):
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv1d(sd, prefix):
    # torch [out, in/groups, k] -> flax [k, in/groups, out]
    p = {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 1, 0))}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _layernorm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _convnext_block(sd, prefix):
    return {
        "dwconv": _conv1d(sd, f"{prefix}.dwconv"),
        "norm": _layernorm(sd, f"{prefix}.norm"),
        "pwconv1": _linear(sd, f"{prefix}.pwconv1"),
        "grn": {"gamma": sd[f"{prefix}.grn.gamma"], "beta": sd[f"{prefix}.grn.beta"]},
        "pwconv2": _linear(sd, f"{prefix}.pwconv2"),
    }


def _stack(dicts: list) -> Any:
    """Stack identically structured trees along a new axis 0."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    return np.stack(dicts, axis=0)


def convert_dit(sd: Mapping[str, np.ndarray], prefix: str = "transformer.") -> Dict[str, Any]:
    """Reference DiT state dict (``dit.py:105-181`` layout) -> the JAX
    ``DiT``'s param tree (scan-stacked blocks)."""
    g = lambda k: f"{prefix}{k}"  # noqa: E731

    params: Dict[str, Any] = {
        "time_embed": {"mlp_in": _linear(sd, g("time_embed.time_mlp.0")),
                       "mlp_out": _linear(sd, g("time_embed.time_mlp.2"))},
        "input_embed": {
            "proj": _linear(sd, g("input_embed.proj")),
            "conv_pos": {"conv1": _conv1d(sd, g("input_embed.conv_pos_embed.conv1d.0")),
                         "conv2": _conv1d(sd, g("input_embed.conv_pos_embed.conv1d.2"))},
        },
        "norm_out": {"mod": _linear(sd, g("norm_out.linear"))},
        "proj_out": _linear(sd, g("proj_out")),
    }
    te: Dict[str, Any] = {"embed": {"embedding": sd[g("text_embed.text_embed.weight")]}}
    i = 0
    while g(f"text_embed.text_blocks.{i}.dwconv.weight") in sd:
        te[f"block_{i}"] = _convnext_block(sd, g(f"text_embed.text_blocks.{i}"))
        i += 1
    params["text_embed"] = te

    depth = 0
    while g(f"transformer_blocks.{depth}.attn_norm.linear.weight") in sd:
        depth += 1
    blocks = []
    for i in range(depth):
        b = g(f"transformer_blocks.{i}")
        block = {
            "attn_norm": {"mod": _linear(sd, f"{b}.attn_norm.linear")},
            "attn": {"to_q": _linear(sd, f"{b}.attn.to_q"), "to_k": _linear(sd, f"{b}.attn.to_k"),
                     "to_v": _linear(sd, f"{b}.attn.to_v"),
                     "to_out": _linear(sd, f"{b}.attn.to_out.0")},
            "ff": {"in_proj": _linear(sd, f"{b}.ff.ff.0.0"),
                   "out_proj": _linear(sd, f"{b}.ff.ff.2")},
        }
        if f"{b}.attn.q_norm.weight" in sd:
            block["attn"]["q_norm"] = {"weight": sd[f"{b}.attn.q_norm.weight"]}
            block["attn"]["k_norm"] = {"weight": sd[f"{b}.attn.k_norm.weight"]}
        blocks.append(block)
    params["blocks"] = {"block": _stack(blocks)}

    if g("long_skip_connection.weight") in sd:
        params["long_skip"] = _linear(sd, g("long_skip_connection"))
    if g("prosody_text_proj.weight") in sd:
        params["prosody_text_proj"] = _linear(sd, g("prosody_text_proj"))
    return params


def _unstack(tree: Any, depth: int) -> list:
    """Inverse of :func:`_stack`."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, depth) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(depth)]
    arr = np.asarray(tree)
    if arr.shape[0] != depth:
        raise ValueError(f"stacked leaf of shape {arr.shape} in a tree of depth {depth}")
    return [arr[i] for i in range(depth)]


def export_dit_state_dict(params: Mapping[str, Any],
                          prefix: str = "transformer.") -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_dit`: a JAX DiT param tree (bare, under
    ``params`` or under ``dit``) -> the reference-layout state dict, f32
    numpy, C order. ``export_dit_state_dict(convert_dit(sd)) == sd``. An
    int8 tree raises ``ValueError``."""
    if "dit" in params:
        params = params["dit"]
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    g = lambda k: f"{prefix}{k}"  # noqa: E731

    def put_linear(key, node):
        sd[f"{key}.weight"] = np.asarray(node["kernel"]).T
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def put_conv1d(key, node):
        sd[f"{key}.weight"] = np.transpose(np.asarray(node["kernel"]), (2, 1, 0))
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def put_convnext(key, node):
        put_conv1d(f"{key}.dwconv", node["dwconv"])
        sd[f"{key}.norm.weight"] = np.asarray(node["norm"]["scale"])
        sd[f"{key}.norm.bias"] = np.asarray(node["norm"]["bias"])
        put_linear(f"{key}.pwconv1", node["pwconv1"])
        sd[f"{key}.grn.gamma"] = np.asarray(node["grn"]["gamma"])
        sd[f"{key}.grn.beta"] = np.asarray(node["grn"]["beta"])
        put_linear(f"{key}.pwconv2", node["pwconv2"])

    stacked = p["blocks"]["block"]
    if has_quantized_leaves(stacked):
        raise ValueError("cannot export int8-quantized params to torch; export the float "
                         "checkpoint the quantized tree was converted from")
    put_linear(g("time_embed.time_mlp.0"), p["time_embed"]["mlp_in"])
    put_linear(g("time_embed.time_mlp.2"), p["time_embed"]["mlp_out"])
    put_linear(g("input_embed.proj"), p["input_embed"]["proj"])
    put_conv1d(g("input_embed.conv_pos_embed.conv1d.0"), p["input_embed"]["conv_pos"]["conv1"])
    put_conv1d(g("input_embed.conv_pos_embed.conv1d.2"), p["input_embed"]["conv_pos"]["conv2"])
    put_linear(g("norm_out.linear"), p["norm_out"]["mod"])
    put_linear(g("proj_out"), p["proj_out"])
    te = p["text_embed"]
    sd[g("text_embed.text_embed.weight")] = np.asarray(te["embed"]["embedding"])
    for name, node in te.items():
        if name.startswith("block_"):
            put_convnext(g(f"text_embed.text_blocks.{int(name.split('_')[1])}"), node)
    depth = int(np.asarray(stacked["attn"]["to_q"]["kernel"]).shape[0])
    for i, block in enumerate(_unstack(stacked, depth)):
        b = g(f"transformer_blocks.{i}")
        put_linear(f"{b}.attn_norm.linear", block["attn_norm"]["mod"])
        for proj in ("to_q", "to_k", "to_v"):
            put_linear(f"{b}.attn.{proj}", block["attn"][proj])
        put_linear(f"{b}.attn.to_out.0", block["attn"]["to_out"])
        put_linear(f"{b}.ff.ff.0.0", block["ff"]["in_proj"])
        put_linear(f"{b}.ff.ff.2", block["ff"]["out_proj"])
        if "q_norm" in block["attn"]:
            sd[f"{b}.attn.q_norm.weight"] = np.asarray(block["attn"]["q_norm"]["weight"])
            sd[f"{b}.attn.k_norm.weight"] = np.asarray(block["attn"]["k_norm"]["weight"])
    if "long_skip" in p:
        put_linear(g("long_skip_connection"), p["long_skip"])
    if "prosody_text_proj" in p:
        put_linear(g("prosody_text_proj"), p["prosody_text_proj"])
    # C order: safetensors' numpy writer stores a transposed view's buffer
    # as if it were C order (the JAX export's .safetensors scrambles them)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def has_quantized_leaves(tree: Any) -> bool:
    """Whether a param tree holds int8 ``kernel_q`` leaves (JAX's
    ``quantize_dense_tree``)."""
    if isinstance(tree, Mapping):
        return "kernel_q" in tree or any(has_quantized_leaves(v) for v in tree.values())
    return False


def convert_cfm(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Normalized reference CFM state dict -> the JAX inference tree
    ``{"dit": ..., "prosody_to_mel": ...?}``."""
    out: Dict[str, Any] = {"dit": convert_dit(sd)}
    if "prosody_to_mel.weight" in sd:
        out["prosody_to_mel"] = _linear(sd, "prosody_to_mel")
    return out


def load_cfm_checkpoint(path: str, use_ema: bool = True,
                        backbone: str = "DiT") -> Dict[str, Any]:
    """A CFM checkpoint -> state dicts of the port's modules, f32:
    ``{"dit": the backbone's, "prosody_to_mel": the Linear's}``, the second
    only when the checkpoint has it. A native directory (:func:`is_native`)
    goes through :func:`load_native_cfm` and the carry-over map of
    ``backbone`` (``"DiT"``, ``"MMDiT"`` or ``"UNetT"``); a reference file
    through ``weights.load_reference_checkpoint``."""
    from lemas_tts_tpu_torch import weights

    if is_native(path):
        tree, to_mel = load_native_cfm(path)
        carry = {"DiT": weights.dit_state_from_jax, "MMDiT": weights.mmdit_state_from_jax,
                 "UNetT": weights.unett_state_from_jax}[backbone]
        state = carry(tree)
        to_mel = weights.prosody_to_mel_from_jax(to_mel) if to_mel is not None else None
    else:
        state, to_mel = weights.load_reference_checkpoint(str(path), use_ema=use_ema)
    return {"dit": state, **({"prosody_to_mel": to_mel} if to_mel is not None else {})}


# ------------------------------------------------------- native (orbax) trees
def is_native(path) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (has ``_METADATA``)."""
    return (Path(path) / "_METADATA").is_file()


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("native (orbax) checkpoints are read and written with the optional "
                          "'tensorstore' package, which is not installed") from e
    return tensorstore


def _kvstore(path: Path) -> dict:
    return {"driver": "ocdbt", "base": f"file://{path}/"}


_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


def load_native(path) -> Any:
    """An orbax ``StandardCheckpointer`` directory -> the nested tree
    (dicts; sequences as lists) with numpy leaves, python scalars where the
    saved leaf was one, ``None`` and empty containers (an empty tuple as
    ``()``) where they were saved."""
    ts = _tensorstore()
    path = Path(path).resolve()
    meta = json.loads((path / "_METADATA").read_text())
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: only OCDBT checkpoints are supported (use_ocdbt is false)")
    leaves, reads = [], []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            leaves.append((keys, _EMPTY[value["value_type"]](), None))
            continue
        spec = {"driver": driver, "kvstore": _kvstore(path),
                "path": ".".join(k for k, _ in keys)}
        reads.append(ts.open(spec, open=True, read=True).result().read())
        leaves.append((keys, None, value["value_type"]))
    arrays = iter([r.result() for r in reads])
    root: Dict[Any, Any] = {}
    for keys, empty, kind in leaves:
        value = empty
        if kind is not None:
            value = np.asarray(next(arrays))
            if kind == "scalar":
                value = value.item()
        node = root
        for key, _ in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1][0]] = value
    return _as_lists(root, {tuple(k for k, _ in keys[:i + 1]): t
                            for keys, _, _ in leaves for i, (_, t) in enumerate(keys)})


def _as_lists(node: Any, types: Dict[tuple, int], at: tuple = ()) -> Any:
    """Turn the dicts whose keys are sequence indices (``key_type`` 1) into
    lists, in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v, types, at + (k,)) for k, v in node.items()}
    if out and all(types.get(at + (k,)) == 1 for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def _flatten(tree: Any, at: Tuple[Tuple[str, int], ...] = ()):
    """(key path as (key, key_type) pairs, leaf) for every leaf, empty
    containers and None included."""
    if isinstance(tree, Mapping) and tree:
        for k, v in tree.items():
            yield from _flatten(v, at + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, at + ((str(i), 1),))
    else:
        yield at, tree


def save_native(tree: Any, path) -> None:
    """Write ``tree`` (nested dicts/lists of numpy arrays, torch tensors,
    python scalars, None) as an orbax ``StandardCheckpointer`` directory
    (zarr v2 over OCDBT, zstd), replacing what is at ``path``."""
    ts = _tensorstore()
    path = Path(path).resolve()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    meta: Dict[str, Any] = {}
    txn = ts.Transaction()
    writes = []
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("save_native needs a tree (a dict or a list), not a bare leaf")
        if leaf is None or isinstance(leaf, (Mapping, list, tuple)):
            kind = ("None" if leaf is None else "Dict" if isinstance(leaf, Mapping)
                    else "Tuple" if isinstance(leaf, tuple) else "List")
            meta[str(tuple(k for k, _ in keys))] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                "value_metadata": {"value_type": kind, "skip_deserialize": True}}
            continue
        if isinstance(leaf, (bool, int, float)):  # python scalars; numpy ones are arrays
            kind, arr = "scalar", np.asarray(leaf)
        else:
            kind = "np.ndarray"
            arr = (leaf.detach().cpu().numpy() if hasattr(leaf, "detach")
                   else np.asarray(leaf))
        arr = np.asarray(arr, order="C")  # ascontiguousarray would make a 0-d leaf 1-d
        zarray = {"dtype": _zarr_dtype(arr.dtype), "compressor": {"id": "zstd", "level": 1},
                  "fill_value": None, "dimension_separator": "."}
        if arr.ndim:  # one chunk a leaf; a 0-d leaf's shape goes as an argument
            zarray["chunks"] = list(arr.shape)
        spec = {"driver": "zarr", "kvstore": _kvstore(path),
                "path": ".".join(k for k, _ in keys), "metadata": zarray}
        store = ts.open(spec, create=True, open=True, shape=list(arr.shape)).result()
        writes.append(store.with_transaction(txn).write(arr))
        meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": kind, "skip_deserialize": False}}
    for w in writes:
        w.result()
    txn.commit_sync()
    (path / "_METADATA").write_text(json.dumps(
        {"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
         "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps(
        {"item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                          "StandardCheckpointHandler",
         "metrics": {}, "performance_metrics": {}, "custom_metadata": {}}))


def _zarr_dtype(dtype: np.dtype) -> str:
    """A zarr v2 dtype string; bfloat16 (``ml_dtypes``) has no numpy code."""
    return "bfloat16" if dtype.name == "bfloat16" else np.dtype(dtype).str


def load_native_cfm(path) -> Tuple[Dict[str, Any], Optional[dict]]:
    """A native CFM directory -> (the backbone's JAX tree, the
    ``prosody_to_mel`` node or None), as the JAX ``TTS`` reads one: a
    ``{"dit", "prosody_to_mel"?}`` tree (``convert_checkpoint --ckpt``), or
    a distillation stage's bare student tree (``{"params": ...}`` or the
    param dict itself)."""
    tree = load_native(path)
    if "dit" not in tree:
        tree = {"dit": tree.get("params", tree)}
    return tree["dit"], tree.get("prosody_to_mel")


def native_dir(path) -> Optional[Path]:
    """``path`` itself if it is a native directory, else its ``native/``
    subdirectory if that is one, else None."""
    p = Path(path)
    for cand in (p, p / "native"):
        if is_native(cand):
            return cand
    return None


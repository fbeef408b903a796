"""VR-arch band-parameter registry: a copy of
``lemas_tts_tpu/uvr5/band_params.py`` with its ``modelparams/`` JSON files
(the port imports and reads nothing of the JAX package).

Equivalent of the reference ``uvr5/lib_v5/vr_network/model_param_init.py``
(``ModelParameters``, ``:44-58``): each VR checkpoint is described by a JSON
band config — per-band sample rate / hop / n_fft / bin-crop window plus
low/high-pass crossover bins and the global pre-filter — which drives the
multi-band STFT analysis/synthesis around the network. The 23 upstream
configs are vendored verbatim under ``modelparams/`` (pure numeric interface
data: they define the checkpoint contract, like the tokenizer vocab).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

PARAM_DIR = pathlib.Path(__file__).parent / "modelparams"

_BOOL_DEFAULTS = ("mid_side", "mid_side_b", "mid_side_b2", "stereo_w",
                  "stereo_n", "reverse")

# reference default_param (model_param_init.py:4-37): used when a checkpoint
# carries no config — a 2-band 44.1 kHz layout
DEFAULT_PARAM: Dict[str, Any] = {
    "bins": 768,
    "unstable_bins": 9,
    "reduction_bins": 762,
    "sr": 44100,
    "pre_filter_start": 757,
    "pre_filter_stop": 768,
    "band": {
        1: {"sr": 11025, "hl": 128, "n_fft": 960, "crop_start": 0,
            "crop_stop": 245, "lpf_start": 61, "res_type": "polyphase"},
        2: {"sr": 44100, "hl": 512, "n_fft": 1536, "crop_start": 24,
            "crop_stop": 547, "hpf_start": 81, "res_type": "sinc_best"},
    },
}


def _int_keys(pairs):
    return {int(k) if isinstance(k, str) and k.isdigit() else k: v
            for k, v in pairs}


def list_band_params() -> list[str]:
    """Names of all vendored band configs (without .json)."""
    return sorted(p.stem for p in PARAM_DIR.glob("*.json"))


def load_band_params(name_or_path: str | None = None) -> Dict[str, Any]:
    """Load a band config by registry name (``"4band_v2"``), JSON path, or a
    ``.pth`` checkpoint containing an embedded ``param.json`` zip entry
    (reference ``ModelParameters.__init__``); ``None`` → the default param.
    Missing stereo-mode booleans are defaulted to False."""
    if name_or_path is None:
        param = json.loads(json.dumps(DEFAULT_PARAM), object_pairs_hook=_int_keys)
    else:
        p = pathlib.Path(name_or_path)
        if p.suffix == ".pth":
            import zipfile

            with zipfile.ZipFile(p, "r") as zf:
                param = json.loads(zf.read("param.json"),
                                   object_pairs_hook=_int_keys)
        else:
            if p.suffix != ".json":
                p = PARAM_DIR / f"{name_or_path}.json"
            if not p.exists():
                raise FileNotFoundError(
                    f"unknown band params {name_or_path!r}; available: "
                    f"{', '.join(list_band_params())}"
                )
            param = json.loads(p.read_text(), object_pairs_hook=_int_keys)
    for k in _BOOL_DEFAULTS:
        param.setdefault(k, False)
    return param

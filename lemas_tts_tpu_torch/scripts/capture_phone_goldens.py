"""Capture phone-string goldens that pin the checkpoint text contract
(counterpart of ``lemas_tts_tpu/scripts/capture_phone_goldens.py``, the
same sentences and JSON schema, through the port's frontend ``text/``).

The frontend's phone-string format (reference ``infer/frontend.py:184-223``
and ``text_norm/tokenizer.py:116-130``) feeds the fixed vocab shipped with
checkpoints, so a drift in it breaks released checkpoints. This script
freezes the frontend's output for a fixed multilingual sentence set into a
JSON fixture (``tests/data/phone_goldens.json``), which records the backend
that produced it::

    python -m lemas_tts_tpu_torch.scripts.capture_phone_goldens \\
        --out tests/data/phone_goldens.json [--vocab_file vocab.txt]

Run where espeak-ng is installed it captures the real espeak contract;
elsewhere the built-in tiers (``builtin-ipa``: the vendored English G2P, the
rule transducers, char tokens, algorithmic pinyin). ``--vocab_file``
snapshots the vocab into the fixture for coverage checks. The frontend is
host work; ``--device`` is checked like every port entry point's (CUDA
unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys

# One sentence per supported language (api.py LANGS), plus mixed/edge cases;
# the same list as the JAX script's.
SENTENCES = [
    ("en", "The quick brown fox jumps over 12 lazy dogs."),
    ("en", "Hello there, #2 general Kenobi!"),
    ("zh", "今天天气真不错，我们去公园散步吧。"),
    ("zh", "他花了1024元买了3本书。"),
    ("zh", "小明说:Hello world,然后就走了。"),  # code-switch
    ("es", "El rápido zorro marrón salta sobre el perro perezoso."),
    ("pt", "A raposa marrom rápida pula sobre o cachorro preguiçoso."),
    ("fr", "Le renard brun rapide saute par-dessus le chien paresseux."),
    ("de", "Der schnelle braune Fuchs springt über den faulen Hund."),
    ("it", "La rapida volpe marrone salta sopra il cane pigro."),
    ("ru", "Быстрая коричневая лиса прыгает через ленивую собаку."),
    ("id", "Rubah coklat cepat melompat di atas anjing malas."),
    ("vi", "Con cáo nâu nhanh nhẹn nhảy qua con chó lười."),
    ("th", "สุนัขจิ้งจอกสีน้ำตาลกระโดดข้ามสุนัขขี้เกียจ"),
    # a second case per language: digits, #n pauses and punctuation, so every
    # language pins its text-normalization route and the pause contract
    ("en", "Chapter 7 begins on page 132, #1 not page 133."),
    ("zh", "会议在2025年3月15日举行, #2 请准时参加。"),
    ("es", "Tengo 25 gatos, #1 y 3 perros en casa."),
    ("pt", "Ele comprou 42 livros em 2024, #2 todos novos!"),
    ("fr", "Il a 7 pommes, #2 et 19 poires aussi?"),
    ("de", "Sie hat 88 Bücher und 5 Stifte, #1 alle neu."),
    ("it", "Ho 31 anni, #3 e 2 gatti neri."),
    ("ru", "У меня 14 книг и 6 ручек, #1 все новые."),
    ("id", "Saya punya 100 buku, #1 dan 7 pena biru."),
    ("vi", "Tôi có 9 quyển sách và 15 cây bút, #2 tất cả mới."),
]


def backend_id() -> str:
    """The live phone backend, recorded in the fixture: ``builtin-ipa``
    without espeak-ng, else espeak's version."""
    from lemas_tts_tpu_torch.text import tokenizer as tok

    if not tok.available():
        return "builtin-ipa"
    try:
        import phonemizer
        from phonemizer.backend import EspeakBackend

        return f"espeak-ng {EspeakBackend.version()} (phonemizer {phonemizer.__version__})"
    except Exception:  # noqa: BLE001 - a version string is only a label
        return "espeak-ng (version unknown)"


def capture_cases() -> list:
    from lemas_tts_tpu_torch.api import process_phone_list
    from lemas_tts_tpu_torch.text import TextNorm

    tn = TextNorm(dtype="phone", strict=False)
    cases = []
    for lang, text in SENTENCES:
        phones = tn.text2phn(text, lang=lang)
        cases.append({"lang": lang, "text": text, "phones": phones,
                      "tokens": process_phone_list(phones.split("|"))})
    return cases


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Capture phone-string goldens.")
    p.add_argument("--out", type=str, default="tests/data/phone_goldens.json")
    p.add_argument("--vocab_file", type=str, default="",
                   help="Snapshot this vocab (one token per line) into the fixture for "
                        "coverage assertions.")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    args = p.parse_args(argv)
    from lemas_tts_tpu_torch.api import select_device

    select_device(args.device)
    fixture = {"backend": backend_id(), "cases": capture_cases()}
    if args.vocab_file:
        with open(args.vocab_file, "r", encoding="utf-8") as f:
            fixture["vocab"] = [ln.rstrip("\n") for ln in f if ln.rstrip("\n")]
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(fixture, f, ensure_ascii=False, indent=1)
    print(f"{len(fixture['cases'])} cases captured with backend={fixture['backend']!r} "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

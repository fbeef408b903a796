"""Offline batch G2P CLI: text files → phone strings, in parallel (counterpart
of ``lemas_tts_tpu/scripts/g2p.py``; host-side work, no device)::

  python -m lemas_tts_tpu_torch.scripts.g2p --input texts.txt --output phones.txt \\
      [--workers 8] [--lang zh] [--separate_langs]

Input: one utterance per line. Output: the ``|``-separated phone string per
line (the checkpoint-contract token format).
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

_worker_frontend = None
_worker_args = None


def _init_worker(frontend_dtype: str, lang: Optional[str], separate: bool):
    global _worker_frontend, _worker_args
    from lemas_tts_tpu_torch.text import TextNorm

    _worker_frontend = TextNorm(dtype=frontend_dtype)
    _worker_args = (lang, separate)


def _convert(line: str) -> str:
    lang, separate = _worker_args
    text = line.strip()
    if not text:
        return ""
    phones = _worker_frontend.text2phn(text + ". ", lang=lang).replace("(cmn)", "(zh)")
    if separate:
        from lemas_tts_tpu_torch.api import process_phone_list

        return "|".join(process_phone_list(phones.split("|")))
    return phones


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch text → phone conversion.")
    p.add_argument("--input", type=str, required=True,
                   help="Text file, one utterance per line ('-' = stdin).")
    p.add_argument("--output", type=str, default="-", help="Output file ('-' = stdout).")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--lang", type=str, default=None,
                   help="Force a language (default: per-line detection).")
    p.add_argument("--frontend", type=str, default="phone", choices=["phone", "char"])
    p.add_argument("--separate_langs", action="store_true",
                   help="Prefix each phone with its (lang) tag.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.input == "-":
        lines: List[str] = sys.stdin.read().splitlines()
    else:
        with open(args.input, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    if args.workers <= 1 or len(lines) < 4:
        _init_worker(args.frontend, args.lang, args.separate_langs)
        results = [_convert(line) for line in lines]
    else:
        with ProcessPoolExecutor(max_workers=args.workers, initializer=_init_worker,
                                 initargs=(args.frontend, args.lang, args.separate_langs),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(_convert, lines, chunksize=16))
    if args.output == "-":
        sys.stdout.write("".join(r + "\n" for r in results))
    else:
        with open(args.output, "w", encoding="utf-8") as out:
            out.write("".join(r + "\n" for r in results))
        print(f"[g2p] {len(results)} lines → {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

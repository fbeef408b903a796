"""Time K6's bf16 kernel against variants of its own design on the card.

``csrc/attention_splash_sm90.cuh`` runs two overlaps: ping-pong between its
two consumer warpgroups (named barriers: one issues its products while the
other runs its softmax) and, inside a warpgroup, the softmax of a tile
while the P V product of the tile before runs; and its grid is persistent.
The package builds one design. This script builds each variant from the shipped sources by a
textual patch, into a directory of its own:

- ``shipped``: both overlaps;
- ``no_pingpong``: the turn barriers taken out, so the two warpgroups issue
  when they are ready;
- ``no_overlap``: each step waits for both of its products before its
  softmax;
- ``neither``: both;
- ``block_per_item``: a grid of one block per item (128 query rows of a
  head), as the hardware schedules them, in place of the persistent grid of
  one block an SM.

and times each (card time, ``utils/profiling.py:device_ms``) at rows 2, 16 x
64 heads, N 1024 and 1280 with a partly masked batch row, in turns with K5
(``vmem_attention``) on the same inputs, after checking each against
``splash_attention_plain`` (bf16 rel-L2 <= 2e-2). With ``--timeline`` it
also builds the shipped kernel with clock stamps (``clock64`` at the start
of a block's first item, once the runs are classed, once q is scaled, after
each step and after the epilogue and the store of that item; the SM clock
taken as 1.98 GHz) and prints their means over the blocks. Run on the card:

    python -m lemas_tts_tpu_torch.scripts.splash_variants [--iters 50] [--timeline]

It prints one line a variant and shape, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# (name, [(text in the shipped header, replacement), ...])
VARIANTS = [
    ("shipped", []),
    ("no_pingpong", [
        ("if (wg == 1) bar_arrive(kTurn, 256);", ""),
        ("if (wg == 0) bar_sync(kTurn, 256);", ""),
        ("bar_sync(kTurn + wg, 256);", ""),
        ("bar_arrive(kTurn + (wg ^ 1), 256);", ""),
    ]),
    ("no_overlap", [("wgmma_wait_one();", "wgmma_wait_all();")]),
]
VARIANTS.append(("neither", VARIANTS[1][1] + VARIANTS[2][1]))
VARIANTS.append(("block_per_item", [("std::min(items, sm90::sm_count(device))", "items")]))
HEADER = "attention_splash_sm90.cuh"


def build_variant(name: str, patches, root: Path, extra_cu: str = ""):
    """attention_splash.cu built with each (old, new) of ``patches``
    replacing every ``old`` in its header, and ``extra_cu`` appended to it;
    returns the library's path."""
    from lemas_tts_tpu_torch.ops import _cuda

    src = root / name
    shutil.copytree(_cuda.CSRC, src)
    text = (src / HEADER).read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in {HEADER}")
        text = text.replace(old, new)
    (src / HEADER).write_text(text)
    (src / "attention_splash.cu").write_text((src / "attention_splash.cu").read_text() + extra_cu)
    out = root / f"{name}.so"
    proc = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(out), str(src / "attention_splash.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} failed to build:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():  # serialized wgmma, spills
        if "splash_sm90" in line and ("C75" in line or "spill" in line):
            print(f"[splash_variants] {name} ptxas: {line.strip()}", flush=True)
    return out


def load(path: Path):
    from lemas_tts_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(path))
    fn = lib.lemas_attention_splash
    fn.argtypes = _cuda.ENTRY_POINTS["attention_splash"]["lemas_attention_splash"]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, mask):
    from lemas_tts_tpu_torch.ops import _cuda, attention

    B, H, N, D = q.shape
    out = torch.empty_like(q)
    err = fn(q.device.index, _cuda.dtype_code(q), D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             mask.data_ptr(), out.data_ptr(), B, N, H, attention.splash_q_scale(D, q.dtype),
             _cuda.stream_ptr(q.device))
    _cuda.check(err, "attention_splash variant")
    return out


# Stamps of consumer 0 of each block's first item: slot 0 the block's start,
# 1 the runs classed, 2 q scaled, 3 + i step i done, 30 the last P V, 31 the
# output stored.
STAMPS = 32


def _stamp(k: str) -> str:
    return ("if (threadIdx.x == 0 && ii == 0) g_stamps[blockIdx.x * %d + (%s)] = "
            "(unsigned long long)clock64();" % (STAMPS, k))


TIMELINE = [
    ("constexpr int kKeys = 128;",
     "__device__ unsigned long long g_stamps[1024 * %d];\nconstexpr int kKeys = 128;" % STAMPS),
    ("  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;",
     "  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;\n"
     "  { const int ii = 0; " + _stamp("0") + " }"),
    ("  auto tile_class = [&]", "  { const int ii = 0; " + _stamp("1") + " }\n  auto tile_class = [&]"),
    ("    qdesc = desc_b128(qw, 1024, 16);", "    qdesc = desc_b128(qw, 1024, 16);\n    " + _stamp("2")),
    ("    ++it;\n  };", "    if (threadIdx.x == 0 && it < 27) g_stamps[blockIdx.x * %d + 3 + it] = "
     "(unsigned long long)clock64();\n    ++it;\n  };" % STAMPS),
    ("    finish_pv((it + ST - 1) % ST);\n    store_out", "    finish_pv((it + ST - 1) % ST);\n    "
     + _stamp("30") + "\n    store_out"),
    ("    store_out<ND>(st, o, out + (size_t)bh * n * D, row0);\n  }",
     "    store_out<ND>(st, o, out + (size_t)bh * n * D, row0);\n    " + _stamp("31") + "\n  }"),
]
READ_STAMPS = ('\nextern "C" int lemas_stamps(void* dst) {\n'
               '  return (int)cudaMemcpyFromSymbol(dst, splash::g_stamps, sizeof(splash::g_stamps));\n}\n')


def timeline(path: Path, sets: list, n: int) -> None:
    """The shipped kernel built with clock stamps (library ``path``); prints
    the means over the blocks of each phase of their first item (us at 1.98
    GHz)."""
    import numpy as np

    fn = load(path)
    lib = ctypes.CDLL(str(path))
    lib.lemas_stamps.argtypes = [ctypes.c_void_p]
    call(fn, *sets[0])
    torch.cuda.synchronize()
    stamps = np.zeros(1024 * STAMPS, np.uint64)
    lib.lemas_stamps(stamps.ctypes.data)
    blocks = min(132, 2 * 16 * n // 128)
    t = stamps.reshape(1024, STAMPS)[:blocks].astype(np.int64)
    us = lambda a, b: float(((t[:, b] - t[:, a]) / 1.98e3).mean())  # noqa: E731
    steps = [us(3 + i, 4 + i) for i in range(n // 128 - 1)]
    print(f"[splash_variants] timeline rows 2 N {n} 16x64, first item of {blocks} blocks (us): "
          f"start to runs classed {us(0, 1):.2f}, to q scaled {us(1, 2):.2f}, to step 0 done "
          f"{us(2, 3):.2f}; steps {', '.join(f'{x:.2f}' for x in steps)}; last step to last "
          f"P V done {us(3 + n // 128 - 1, 30):.2f}; to stored {us(30, 31):.2f}", flush=True)


def main(argv=None) -> int:
    from lemas_tts_tpu_torch.ops import attention
    from lemas_tts_tpu_torch.utils.profiling import device_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--timeline", action="store_true",
                    help="also print the phases of the shipped kernel's blocks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("splash_variants needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[splash_variants] {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        builds = VARIANTS + ([("timeline", TIMELINE, READ_STAMPS)] if args.timeline else [])
        with ThreadPoolExecutor(len(builds)) as pool:
            paths = dict(zip([v[0] for v in builds],
                             pool.map(lambda v: build_variant(*v[:2], root, *v[2:]), builds)))
        stamped = paths.pop("timeline", None)
        fns = {name: load(path) for name, path in paths.items()}
        for n in (1024, 1280):
            g = torch.Generator(device="cuda").manual_seed(n)
            sets = []
            for _ in range(3):
                q, k, v = (torch.randn(2, 16, n, 64, generator=g, device="cuda")
                           .to(torch.bfloat16) for _ in range(3))
                mask = torch.arange(n, device="cuda")[None, :] < torch.tensor(
                    [n - 37, n], device="cuda")[:, None]
                sets.append((q, k, v, mask))
            ref = attention.splash_attention_plain(*sets[0])
            k5 = [lambda a=a: attention.vmem_attention(*a) for a in sets]
            for name, fn in fns.items():
                got = call(fn, *sets[0])
                err = float((got.float() - ref.float()).norm() / ref.float().norm())
                if err > 2e-2:
                    raise SystemExit(f"variant {name} N {n}: rel-L2 {err:.3e} over 2e-2")
                kern = [lambda a=a, fn=fn: call(fn, *a) for a in sets]
                t = [device_ms(f, iters=args.iters) for f in (k5, kern, kern, k5)]
                k5_ms, k6_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                print(f"[splash_variants] {name:14s} rows 2 N {n} 16x64: ms {k6_ms:.4f} "
                      f"(K5 {k5_ms:.4f}, K6/K5 {k6_ms / k5_ms:.3f}) rel-L2 {err:.3e}",
                      flush=True)
            if stamped is not None:
                timeline(stamped, sets, n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

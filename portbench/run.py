"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload multilingual.single-1chunk --seed 7 \\
        --seconds 45 --trace 0

From the root of a checkout of the repository: builds the port's kernels if
they are missing, makes the weights and the traffic from ``--seed``, builds
and warms the system (all of that is ``setup_s``), measures for
``--seconds``, then checks a sample of the finished requests against the
plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled slice. The last line of
standard output is the result; the last lines of standard error are the
numbers that decide ``correct``, each with its limit.

Exits 2 without a result when there is no CUDA device, fewer than the cell
asks for, no port in the checkout, or no file for the backbone, the vocoder
or a kernel that the cell names; exits 3 without a result when the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lemas_tts_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not bring in,
    compared whole (``lemas_tts_tpu_torch`` is not ``lemas_tts_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def keep_caches_in(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _finite(x):
    return x if x is None or math.isfinite(x) else 1e30


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None) -> dict:
    """One run of ``workload``: the result dict (``checks`` last)."""
    import torch

    from portbench import check, drive, system
    from portbench import trace as tracing
    from portbench import traffic as gen
    from portbench.spec import Bench

    t0 = time.perf_counter() if t0 is None else t0
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg_entry = next(c for c in bench.doc["configs"] if c["name"] == cell.config_name)
    readers = bench.readers(cell.per_layer if trace else
                            [m for m in cell.end_to_end if m["name"] != "setup_s"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    pool = gen.pool(cell.traffic, seed)
    t_build = time.perf_counter()
    system.build_kernels(dev)
    t_build = time.perf_counter() - t_build
    sysm = system.build(cell, cell.traffic, root / cfg_entry["file"], seed, dev)
    system.warm(sysm, pool, cell.traffic)
    setup_s = time.perf_counter() - t0
    print(f"[portbench] {workload} seed {seed}: kernels built in {t_build:.1f} s, "
          f"set-up {setup_s:.1f} s", file=sys.stderr, flush=True)

    window = drive.ENTRIES[cell.traffic["entry"]](sysm, pool, cell.traffic, seed, seconds, trace)
    sl = window.slice
    profile = None
    if trace:
        if not sl.done:
            raise RuntimeError("the profiled slice did not happen inside the window: "
                               f"from {sl.t_from:.3f}, {len(window.spans)} batches, "
                               f"{'; '.join(sl.notes)}")
        profile = tracing.read(sl.prof, sl.t1 - sl.t0)
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0

    run = SimpleNamespace(window=window, cell=cell, pool=pool, profile=profile,
                          traffic=cell.traffic, config=cell.config, backbone=cell.backbone,
                          kernel=bench.kernel)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    for name, read in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}

    # the program's state goes before the reference runs
    host_weights = sysm.host_weights
    del sysm, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(1 for r in window.records if not r.ok)
    picks = check.pick(window.records, int(cell.traffic["check"]["requests"]), seed)
    bits = {"int8": 8}.get(cell.traffic.get("quant"))
    model = check.reference_model(cell, host_weights, dev, bits)
    numbers = check.compare(picks, pool, model, cell.traffic, dev)
    if not picks:  # nothing finished: every gap fails
        numbers = {k: float("inf") for k in cell.limits}
    numbers["failed_requests"] = float(failed)
    print(f"[portbench] every candidate number: {json.dumps(numbers)}", file=sys.stderr)
    correct, checks = check.judge(numbers, cell.limits)

    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": len(window.records), "failed": failed,
              "metrics": metrics, "device": devinfo}
    if profile is not None:
        devinfo["busy_s"] = profile.busy_s
        devinfo["window_s"] = profile.window_s
        result["breakdown"] = tracing.breakdown(profile)
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    keep_caches_in(root)
    if not (root / "lemas_tts_tpu_torch").is_dir():
        print("[portbench] no lemas_tts_tpu_torch in this checkout: nothing to measure",
              file=sys.stderr)
        return 2
    import torch

    from portbench.spec import Bench

    try:
        chips = Bench(root).cell(args.workload).chips
    except LookupError as e:  # no such cell, or a family or kernel without its file
        print(f"[portbench] {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      t0=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the process holds {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The launch counters of the kernel wrappers (``.launches`` on each), by
kernel name. A wrapper adds one through ``count`` where it launches its
kernel. While a thread captures a CUDA graph (``recording``), its launches
go to the capture's record instead: the capture runs nothing, and the graph
adds that record at every replay (``cfm/graph.py``). So a count is the
kernel's launches on the card, whether they came from Python or from a
graph, and another thread's launches during a capture stay its own."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

_lock = threading.Lock()
_local = threading.local()


def counters() -> dict:
    """Every kernel wrapper, by kernel name."""
    from lemas_tts_tpu_torch.ops import attention, conv, ffn

    return {"qkv_block": ffn.qkv_block, "vmem_attention_nhd": attention.vmem_attention_nhd,
            "vmem_attention_nhd_pack": attention.vmem_attention_nhd_pack,
            "vmem_attention": attention.vmem_attention,
            "splash_attention": attention.splash_attention, "ffn_block": ffn.ffn_block,
            "conv_taps_mish": conv.conv_taps_mish}


def count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: to its counter, or to this
    thread's record while it captures."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[wrapper.__name__] = record.get(wrapper.__name__, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Within it, this thread's launches go to the dict it yields, by kernel
    name, and not to the counters."""
    _local.record = record = {}
    try:
        yield record
    finally:
        _local.record = None


def add(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counters (a graph's record, at a replay)."""
    with _lock:
        for k, f in counters().items():
            f.launches += delta.get(k, 0)

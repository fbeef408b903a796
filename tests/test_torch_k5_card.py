"""K5's bf16 kernel (``ops/attention.py:vmem_attention``,
``csrc/attention_bhnd.cuh``) walks 128-key tiles and skips, in a batch row
with a kept key, the tiles whose keys are all padded.

On the CPU: the skip rule (``vmem_walked_tiles``, ``vmem_key_tiles``) on
hand-worked masks, and the plain version over only the walked tiles against
the plain version over every key (a skipped key's p is exactly 0, so the two
differ only by the order of the sums). The ``card`` cases hold the kernel
against the plain version on the chip, at ragged and whole N, d64 and d128,
with no mask, the UNetT's mask (time token kept, the frames kept, the tail
padded, both CFG rows alike), holes inside the valid span and a batch row
all padded (the mean of v), and its tile counter against ``vmem_key_tiles``
(``python -m pytest tests/test_torch_k5_card.py -m card --noconftest``).
"""

import os
import time

import pytest
import torch

from lemas_tts_tpu_torch.ops import attention

NS = [1, 63, 64, 65, 127, 128, 129, 1000, 1024, 1025, 1088, 1280, 1536, 1537]
MASKS = ["none", "unett", "holes", "row_padded"]


def make_mask(kind: str, rows: int, n: int, device="cpu"):
    """A [rows, n] key mask, or None: ``unett`` keeps the time token and
    784-1008 frames (1024 bucket) or 1040-1520 (1536 bucket), scaled to
    shorter n, the rest padded, every row alike; ``holes`` keeps the first
    n - n // 8 keys but for whole 128-key runs and short runs inside them;
    ``row_padded`` is ``holes`` with batch row 1 all padded."""
    if kind == "none":
        return None
    pos = torch.arange(n, device=device)
    if kind == "unett":
        frames = n - 1
        kept = 1 + (784 * frames // 1024 if frames <= 1024 else 1040 * frames // 1536)
        return (pos < kept)[None].expand(rows, n).contiguous()
    keep = (pos < n - n // 8) & ~((pos >= 128) & (pos < 256)) & ~((pos >= 300) & (pos < 317))
    keep[0] = True
    mask = keep[None].expand(rows, n).contiguous()
    if kind == "row_padded":
        mask[1] = False
    return mask


# (mask rows as (kept ranges), n, heads): walked, total
HAND = [
    (None, 1025, 16, 2, (2 * 9 * 16 * 9, 2 * 9 * 16 * 9)),
    ([[(0, 785)], [(0, 785)]], 1025, 16, 2, (2 * 7 * 16 * 9, 2 * 9 * 16 * 9)),
    ([[(0, 1025)], []], 1025, 16, 2, (2 * 9 * 16 * 9, 2 * 9 * 16 * 9)),
    ([[(0, 1)]], 1, 4, 1, (4, 4)),
    ([[]], 1, 4, 1, (4, 4)),
    ([[(0, 100), (384, 500)]], 512, 2, 1, (2 * 2 * 4, 4 * 2 * 4)),
    ([[(128, 256)]], 256, 1, 1, (1 * 2, 2 * 2)),
    ([[(0, 128)]], 128, 3, 1, (3, 3)),
    ([[(0, 128)], [(129, 130)]], 130, 1, 2, ((1 + 1) * 2, 4 * 2)),
]


def _hand_mask(ranges, n):
    if ranges is None:
        return None
    mask = torch.zeros(len(ranges), n, dtype=torch.bool)
    for b, row in enumerate(ranges):
        for lo, hi in row:
            mask[b, lo:hi] = True
    return mask


@pytest.mark.parametrize("ranges,n,heads,batch,want", HAND)
def test_key_tiles_hand_worked(ranges, n, heads, batch, want):
    """Walked and total key tiles of a call, worked out by hand: 9 tiles at
    n 1025, of which the UNetT's 785 kept keys fill 7; a row with no kept
    key walks every tile; one tile at n <= 128; an item per 128 query rows
    of each head."""
    assert attention.vmem_key_tiles(_hand_mask(ranges, n), n, heads, batch) == want


def test_walked_tiles_rule():
    """A tile is walked iff it holds a kept key, or its row holds none."""
    mask = _hand_mask([[(0, 10), (300, 301)], [], [(256, 384)]], 400)
    assert attention.vmem_walked_tiles(mask, 400).tolist() == [
        [True, False, True, False], [True, True, True, True], [False, False, True, False]]
    assert attention.vmem_walked_tiles(None, 257, batch=3).shape == (3, 3)


def _plain_over_walked(q, k, v, mask):
    """The plain version per batch row over only the keys of its walked tiles."""
    n = q.shape[2]
    walked = attention.vmem_walked_tiles(mask, n, q.shape[0])
    outs = []
    for b in range(q.shape[0]):
        keys = walked[b].repeat_interleave(attention.KEY_TILE)[:n]
        m = None if mask is None else mask[b:b + 1, keys]
        outs.append(attention.vmem_attention_plain(q[b:b + 1, :, :, :], k[b:b + 1, :, keys],
                                                   v[b:b + 1, :, keys], m))
    return torch.cat(outs)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", [(1, 64), (65, 128), (129, 64), (300, 64), (1025, 64),
                                 (1537, 128)])
def test_skipping_walked_tiles_changes_nothing(kind, n, d):
    """In f32 the plain version over the walked tiles equals it over every
    key up to the order of the sums: every skipped key is padded in a row
    with a kept key, so its p is exactly 0."""
    g = torch.Generator().manual_seed(n + d)
    q, k, v = (torch.randn(2, 2, n, d, generator=g) for _ in range(3))
    mask = make_mask(kind, 2, n)
    full = attention.vmem_attention_plain(q, k, v, mask)
    torch.testing.assert_close(_plain_over_walked(q, k, v, mask), full, rtol=1e-6, atol=1e-6)
    if kind == "row_padded":  # no kept key: every tile walked, the mean of v
        torch.testing.assert_close(full[1], v[1].mean(dim=1, keepdim=True).expand_as(full[1]),
                                   rtol=1e-5, atol=1e-6)


def test_plain_version_takes_no_counter():
    q = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="counts"):
        attention.vmem_attention(q, q, q, None, counts=torch.zeros(2, dtype=torch.int64))


# ----------------------------------------------------------------- the card
def _finish(timeout_s: float = 60.0) -> None:
    """Wait for the card's queue, leaving the process if it hangs (a
    deadlocked kernel would hold the card to the call's time limit)."""
    ev = torch.cuda.Event()
    ev.record()
    deadline = time.monotonic() + timeout_s
    while not ev.query():
        if time.monotonic() > deadline:
            print(f"K5 did not finish within {timeout_s} s: leaving", flush=True)
            os._exit(3)
        time.sleep(0.001)


def _rel_l2(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))


@pytest.mark.card
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", NS)
def test_card_k5_matches_plain(n, d, kind):
    """bf16 K5 on the card against its plain version at rows 2, 16 x 64 or
    8 x 128 heads, under ``chip_smoke.py``'s ``TOL_REL_L2``; an all-padded
    row against the mean of v; the kernel's tile counter against
    ``vmem_key_tiles``, with the share of key tiles skipped printed."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    from chip_smoke import TOL_REL_L2

    heads = 16 if d == 64 else 8
    g = torch.Generator(device="cuda").manual_seed(n * 7 + d)
    q, k, v = (torch.randn(2, heads, n, d, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = make_mask(kind, 2, n, "cuda")
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = attention.vmem_attention.launches
    got = attention.vmem_attention(q, k, v, mask, counts=counts)
    _finish()
    assert attention.vmem_attention.launches == before + 1
    ref = attention.vmem_attention_plain(q, k, v, mask)
    err = _rel_l2(got, ref)
    walked, total = attention.vmem_key_tiles(mask, n, heads, 2)
    print(f"K5 bf16 N {n} d{d} mask {kind}: rel-L2 {err:.3e}; key tiles walked {walked} of "
          f"{total} ({100 * (1 - walked / total):.1f} % skipped)", flush=True)
    assert bool(torch.isfinite(got).all())
    assert err <= TOL_REL_L2["bf16"], err
    assert counts.tolist() == [walked, total]
    if kind == "row_padded":
        mean_v = v[1].float().mean(dim=1, keepdim=True).expand(heads, n, d)
        assert _rel_l2(got[1], mean_v) <= TOL_REL_L2["bf16"]


@pytest.mark.card
@pytest.mark.parametrize("kind", ["none", "row_padded"])
@pytest.mark.parametrize("n,d", [(65, 64), (1025, 64), (1537, 128)])
def test_card_k5_f32_path(n, d, kind):
    """The f32 checking path, unchanged, under the same signature."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    from chip_smoke import TOL_REL_L2

    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v = (torch.randn(2, 4, n, d, generator=g, device="cuda") for _ in range(3))
    mask = make_mask(kind, 2, n, "cuda")
    got = attention.vmem_attention(q, k, v, mask)
    _finish()
    assert _rel_l2(got, attention.vmem_attention_plain(q, k, v, mask)) <= TOL_REL_L2["f32"]
    with pytest.raises(ValueError, match="counts"):
        attention.vmem_attention(q, k, v, mask, counts=torch.zeros(2, dtype=torch.int64,
                                                                   device="cuda"))

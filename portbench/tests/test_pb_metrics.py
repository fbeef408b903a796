"""The end-to-end arithmetic: the rate over the whole window, the tail over
every request, a stalled one and a failed one included."""

import numpy as np
import pytest

from portbench.drive import Record, Window, rate_and_tail


def _window(records, seconds=10.0):
    return Window(t_start=100.0, seconds=seconds, records=records, spans=[])


def test_rate_counts_audio_finished_inside_the_window_over_all_of_it():
    recs = [Record(0, 100.0, 101.0, True, 2.0), Record(1, 101.0, 109.5, True, 3.0),
            Record(2, 109.0, 111.0, True, 5.0)]  # finished after the close
    rate, _ = rate_and_tail(_window(recs), 60.0)
    assert rate == pytest.approx(5.0 / 10.0)


def test_tail_takes_every_request_with_a_stalled_and_a_failed_one():
    recs = [Record(i, 100.0 + i * 0.1, 100.0 + i * 0.1 + 0.2, True, 1.0) for i in range(40)]
    recs.append(Record(40, 104.0, 134.0, True, 1.0))  # stalled 30 s, finished in the drain
    recs.append(Record(41, 105.0, 105.5, False, 0.0, "TimeoutError"))  # failed: the timeout
    _, p95 = rate_and_tail(_window(recs), 60.0)
    lat = [200.0] * 40 + [30000.0, 60000.0]
    assert p95 == pytest.approx(float(np.percentile(lat, 95)))
    assert p95 > 200.0


def test_empty_window_has_no_tail():
    assert rate_and_tail(_window([]), 60.0) == (0.0, None)


def _traced(ops):
    """A traced serving run whose slice made one batch of 4 rows at 1024."""
    import json
    from types import SimpleNamespace

    from portbench.drive import Span
    from portbench.spec import Bench
    from portbench.tests.tiny import REPO
    from portbench.trace import Profile

    bench = Bench(REPO)
    cfg = json.loads((REPO / "portbench/configs/multilingual.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/serve-c8-bf16.json").read_text())
    spans = [Span(0.0, 1.0, 4, 1024, [900] * 4)]
    return SimpleNamespace(window=SimpleNamespace(slice=SimpleNamespace(spans=spans)),
                           profile=Profile(1.0, ops), config=cfg,
                           backbone=bench.family("backbone", "DiT"), kernel=bench.kernel,
                           traffic=traffic)


K3 = "void (anonymous namespace)::attn_nhd_sm90_kernel<64, false>(CUtensorMap)"


def test_roofline_share_over_the_calls_the_batches_make():
    from portbench import roofline
    from portbench.readings import roofline_share

    run = _traced([])
    bound = roofline.batch_bounds(run.backbone, run.config, run.traffic["sampler"], None, 1024,
                                  [900] * 4)["K3"]
    per = bound[1] / bound[0] * 1e6  # us at the roofline a call
    ops = [(K3, 10.0 * i * per, 2.0 * per) for i in range(bound[0])]
    assert roofline_share(_traced(ops), ("K3",)) == pytest.approx(50.0)
    # a trace that lost a few calls counts those it holds; one that lost more
    # than MIN_CALLS_FOUND allows, or holds one more, has no roofline
    assert roofline_share(_traced(ops[3:]), ("K3",)) == pytest.approx(50.0)
    assert roofline_share(_traced(ops[len(ops) // 10:]), ("K3",)) is None
    assert roofline_share(_traced(ops + [(K3, -5 * per, per)]), ("K3",)) is None
    # card time is the union of the kernel's intervals: records that overlap
    # do not count twice
    n = bound[0]
    ops = [(K3, 1.5 * i * per, 2.0 * per) for i in range(n)]
    assert roofline_share(_traced(ops), ("K3",)) == pytest.approx(100.0 * n / (1.5 * (n - 1) + 2))

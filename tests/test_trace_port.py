"""trace_port.py's arithmetic over the program's records, on synthetic
timelines: self times, the idle gaps split by the innermost span (a
partition of the gaps), the tail's stages and the clock anchors' map."""

import numpy as np
import pytest

import trace_port as tp


def span(name, t0, t1, thread=1, id=0):
    return (name, thread, t0, t1, id)


def test_self_time_subtracts_direct_children_on_the_same_thread():
    spans = [span("warm", 0, 100), span("load", 10, 40),
             span("inner", 15, 20), span("load", 50, 60),
             span("other", 5, 95, thread=2)]
    own = tp.self_ns(spans)
    assert [own[i] for i in range(5)] == [100 - 30 - 10, 30 - 5, 5, 10, 90]
    got = tp.setup_self_s([span("setup.warmup", 0, 100),
                           span("setup.kernel_load", 10, 40),
                           span("setup.capture", 200, 260),
                           ("engine.request", 1, 0, 5, 0, (1, 2, 3, 4))],
                          before_ns=150)
    assert got == {"setup.kernel_load": 30e-9, "setup.warmup": 70e-9,
                   "setup.capture": 0.0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_split_partitions_the_gaps(seed):
    r = np.random.default_rng(seed)
    # a launching thread's nested spans: batches of collect, then assemble
    # and a replay inside a dispatch span, on a line with holes
    spans, t = [], 0
    for b in range(20):
        c0, c1 = t, t + int(r.integers(1, 50))
        spans.append((c0, c1, "collect"))
        d0 = c1 + int(r.integers(0, 5))
        a1 = d0 + int(r.integers(1, 20))
        r1 = a1 + int(r.integers(1, 30))
        d1 = r1 + int(r.integers(0, 5))
        spans += [(d0, d1, "dispatch"), (d0, a1, "assemble"),
                  (a1, r1, "replay")]
        t = d1 + int(r.integers(0, 10))
    gaps, g = [], -20.0
    while g < t + 20:
        a = g + float(r.uniform(0, 15))
        b = a + float(r.uniform(0, 15))
        gaps.append((a, b))
        g = b
    rows = tp.idle_by_span(gaps, spans)
    assert sum(rows.values()) == pytest.approx(sum(b - a for a, b in gaps))
    assert set(rows) <= {"idle while collect", "idle while dispatch",
                         "idle while assemble", "idle while replay",
                         "idle outside any span"}
    # brute force on a fine grid: the innermost span at each point
    grid = np.arange(-20, t + 20, 0.25) + 0.125
    want = {}
    for x in grid:
        if not any(a <= x < b for a, b in gaps):
            continue
        over = [s for s in spans if s[0] <= x < s[1]]
        inner = max(over, key=lambda s: (s[0], -s[1])) if over else None
        key = (f"idle while {inner[2]}" if over
               else "idle outside any span")
        want[key] = want.get(key, 0) + 0.25
    for k, v in want.items():
        assert rows.get(k, 0) == pytest.approx(v, abs=0.25 * len(gaps) * 2)


def test_idle_split_of_one_gap_by_hand():
    spans = [(0, 10, "a"), (2, 4, "b"), (12, 20, "c")]
    assert tp.idle_by_span([(1, 15), (19, 25)], spans) == {
        "idle while a": 1 + 6, "idle while b": 2,
        "idle outside any span": 2 + 5, "idle while c": 3 + 1}


def test_tail_stages_sum_to_the_tail_engine_time():
    r = np.random.default_rng(0)
    reqs = []
    for i in range(200):
        edges = np.cumsum(r.integers(0, 10 ** 7, 6))
        reqs.append(("engine.request", 1, int(edges[0]), int(edges[-1]),
                     i // 20, tuple(int(e) for e in edges[1:-1])))
    tail = tp.tail_stages(reqs)
    assert tail["requests"] == 10
    assert list(tail["stage_ms"]) == ["queue", "coalesce", "dispatch",
                                      "inflight", "resolve"]
    assert sum(tail["stage_ms"].values()) == pytest.approx(tail["engine_ms"])
    eng = sorted(r[3] - r[2] for r in reqs)
    assert tail["engine_ms"] == pytest.approx(np.mean(eng[-10:]) / 1e6)


class _Event:
    def __init__(self, dev_ms):
        self.dev_ms = dev_ms

    def elapsed_time(self, other):
        return other.dev_ms - self.dev_ms


class _Anchor:
    def __init__(self, dev_ms, host_ns, error_ns):
        self.event, self.host_ns, self.error_ns = (_Event(dev_ms), host_ns,
                                                   error_ns)


def test_clock_map_and_idle_rows_on_the_host_clock():
    timer = type("T", (), {})()
    # the device clock runs 1e-4 slow against the host's; the window opens
    # 2 device ms after the first anchor
    timer.anchors = [_Anchor(0.0, 10 ** 9, 3000),
                     _Anchor(1000.0, 10 ** 9 + 1000.1 * 10 ** 6, 5000)]
    timer.window = [_Event(2.0)]
    clk = tp.clock(timer)
    assert clk["drift_ppm"] == pytest.approx(100.0)
    assert clk["w0_ns"] == pytest.approx(10 ** 9 + 2.0002e6)
    assert (clk["open_error_ms"], clk["close_error_ms"]) == (0.003, 0.005)
    read = {"window_s": 0.9, "intervals": [(0.0, 0.1), (0.12, 0.5),
                                           (0.53, 0.8)]}
    w0 = clk["w0_ns"]
    spans = [span("engine.collect", w0 + 0.095e9, w0 + 0.125e9, thread=7),
             span("engine.replay", w0 + 0.5e9, w0 + 0.51e9, thread=7),
             span("engine.d2h", w0, w0 + 0.9e9, thread=8)]
    rows = tp.idle_rows(read, clk, spans, launcher=7)
    assert rows["between_timed_calls_s"] == pytest.approx(0.05)
    assert rows["rows_sum_s"] == pytest.approx(0.05 * clk["scale"])
    assert rows["rows_s"]["idle while engine.collect"] == pytest.approx(
        0.02 * clk["scale"])
    assert rows["rows_s"]["idle while engine.replay"] == pytest.approx(
        0.51 - 0.5 * clk["scale"])


def test_d2h_split_at_the_batch_event():
    to_ns = lambda ev: ev.dev_ms * 1e6                  # noqa: E731
    recs = [("engine.d2h", 2, 0, 10 * 10 ** 6, 0, _Event(4.0)),
            ("engine.d2h", 2, 20 * 10 ** 6, 23 * 10 ** 6, 1, _Event(19.0)),
            ("engine.d2h", 2, 30 * 10 ** 6, 40 * 10 ** 6, 2, _Event(36.0)),
            ("engine.d2h", 2, 50 * 10 ** 6, 51 * 10 ** 6, 3, None),
            ("engine.resolve", 2, 0, 1, 0)]
    got = tp.d2h_split(recs, to_ns, 0, 10 ** 9)
    # waits 4, 0 (done before the call), 6; after 6, 3, 4
    assert got == {"calls": 3, "device_wait_ms": 4.0,
                   "after_device_ms": 4.0}
    assert tp.spans_of(recs)[0] == recs[0][:5]

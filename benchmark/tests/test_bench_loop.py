"""A small dialog cell on the CPU: the closed loop never has more stage
requests in flight than conversations, each conversation one at a time,
and the run's line holds what the contract asks."""

import threading
import time

import pytest
import torch

from benchmark import run as R
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def dialog_run():
    torch.set_num_threads(2)
    cell = tiny.cell("s2s.dialog-c32")
    from benchmark.lib import registry

    drv = registry.driver(cell["traffic"]["driver"])
    res = drv.run(cell, 2**31 + 7, 3.0, False, torch.device("cpu"), R.T_START)
    return cell, res


def test_closed_loop_in_flight(dialog_run):
    cell, res = dialog_run
    reqs = [r for r in res["rec"]["requests"] if r.arrivals]
    assert len(reqs) > cell["traffic"]["conversations"]
    events = []
    for r in reqs:
        events += [(r.t_submit, 1), (r.arrivals[-1][0], -1)]
    live = peak = 0
    for _, d in sorted(events, key=lambda e: (e[0], e[1])):
        live += d
        peak = max(peak, live)
    assert peak <= cell["traffic"]["conversations"]
    by_conv = {}
    for r in sorted(reqs, key=lambda r: r.t_submit):
        last = by_conv.get(r.conv)
        assert last is None or r.t_submit >= last
        by_conv[r.conv] = r.arrivals[-1][0]


def test_result_line_shape():
    line = R.run_cell(tiny.cell("s2s.dialog-c32"), 11, 1.5, False, "cpu")
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"dialog_tok_s", "setup_s"}


class _FakeWindow:
    """trace.Window's interface, recording which thread calls what."""

    seen: list = []

    def __init__(self, host_ops=True):
        assert host_ops is False  # the card's activity alone
        self.t0 = self.t1 = None

    def start(self):
        self.seen.append(("start", threading.get_ident()))
        self.t0 = time.perf_counter()

    def stop(self):
        self.seen.append(("stop", threading.get_ident()))
        self.t1 = time.perf_counter()

    def reduce(self):
        self.seen.append(("reduce", threading.get_ident()))
        return {"device_ops": 1}


class _FakeEngine:
    ticks = 0

    def tick(self):
        self.ticks += 1
        time.sleep(0.01)

    def stats(self):
        _FakeWindow.seen.append(("stats", threading.get_ident()))
        return {"steps": self.ticks}


@pytest.fixture
def fake_window(monkeypatch):
    from benchmark.lib import trace

    monkeypatch.setattr(trace, "Window", _FakeWindow)
    _FakeWindow.seen = []
    return _FakeWindow.seen


def _tick_on_a_thread(eng, n):
    th = threading.Thread(target=lambda: [eng.tick() for _ in range(n)])
    th.start()
    th.join()
    return th.ident


def test_profiler_window_opens_and_closes_on_the_engine_thread(fake_window):
    """The traced run's profiler starts and stops between two ticks on the
    thread that ticks the engine, its trace is reduced only at close, and
    the counters of the window's marks are read on that thread too."""
    from benchmark.drivers import dialog as D

    seen, eng = fake_window, _FakeEngine()
    now = time.perf_counter()
    marks = D.EngineMarks(eng, {"open": now + 0.02, "close": now + 0.3}, now + 0.05, 0.1)
    ident = _tick_on_a_thread(eng, 40)
    assert marks.close() == {"device_ops": 1}
    assert [k for k, _ in seen if k != "stats"] == ["start", "stop", "reduce"]
    assert {i for k, i in seen if k != "reduce"} == {ident} != {seen[-1][1]}
    st = marks.stats
    assert 0 < st["open"]["steps"] <= st["trace0"]["steps"] < st["trace1"]["steps"]
    assert st["trace1"]["steps"] <= st["close"]["steps"] < 40
    assert "tick" not in vars(eng)  # the engine's own tick is back


def test_profiler_stops_by_the_window_close_and_warms_on_the_engine_thread(fake_window):
    """A profiler that started late still stops on the engine's thread by
    `trace_by`, and the set-up's warm start and stop run there too."""
    from benchmark.drivers import dialog as D

    seen, eng = fake_window, _FakeEngine()
    D.warm_profiler(eng)
    ident = _tick_on_a_thread(eng, 1)
    assert [(k, i) for k, i in seen] == [("start", ident), ("stop", ident)]
    assert "tick" not in vars(eng) and eng.ticks == 1
    seen.clear()
    now = time.perf_counter()
    marks = D.EngineMarks(eng, {"open": now}, now, trace_s=60.0, trace_by=now + 0.1)
    ident = _tick_on_a_thread(eng, 20)
    assert marks.close() == {"device_ops": 1}
    assert [i for k, i in seen if k in ("start", "stop")] == [ident, ident]
    assert marks.stats["trace1"]["steps"] < 20

"""The end-to-end readers: the tail is over every request and the rates over
the whole window, so a stall inside the window moves both."""

from types import SimpleNamespace

from benchmark.lib import registry
from benchmark.lib.stats import percentile, spread


def _req(t_submit, t_first, arrivals):
    return SimpleNamespace(t_submit=t_submit, t_first=t_first, arrivals=arrivals)


def _dialog_rec(stall=0.0):
    """100 requests, one a second from t = 0.5, each answered 0.2 s later with
    10 tokens; requests from t = 50 wait `stall` more."""
    reqs = []
    for i in range(100):
        t = 0.5 + i
        d = 0.2 + (stall if t >= 50 else 0.0)
        reqs.append(_req(t, t + d, [(t + d, 10)]))
    return {"kind": "dialog", "window": (0.0, 100.0), "calm": (0.0, 100.0), "requests": reqs}


def _read(name, rec):
    return registry.metric_reader(name)(rec)


def test_percentile_nearest_rank_over_all():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95 and percentile(vals, 100) == 100
    assert percentile([3.0], 95) == 3.0
    assert abs(spread([1, 2, 3, 4, 5]) - (4.5 - 1.5) / 3) < 1e-12


def test_stall_moves_the_tail_and_the_rate():
    calm, stalled = _dialog_rec(), _dialog_rec(stall=60.0)
    assert abs(_read("ttft_p95_s.dialog", calm) - 0.2) < 1e-9
    assert _read("ttft_p95_s.dialog", stalled) > 60.0
    assert _read("dialog_tok_s", calm) == 1000 / 100.0
    # the stalled requests' tokens land past the window: the rate drops
    assert _read("dialog_tok_s", stalled) < _read("dialog_tok_s", calm)


def test_tail_leaves_out_the_traced_part_of_the_window():
    rec = _dialog_rec(stall=60.0)  # the stall starts at t = 50
    rec["calm"] = (0.0, 50.0)  # the profiler opened at t = 50
    assert abs(_read("ttft_p95_s.dialog", rec) - 0.2) < 1e-9


def test_request_without_first_token_is_infinite():
    rec = _dialog_rec()
    rec["requests"].append(_req(99.9, None, []))
    rec["requests"].extend(_req(99.9, None, []) for _ in range(5))
    assert _read("ttft_p95_s.dialog", rec) == float("inf")


def test_train_rate_over_the_whole_window():
    steps = [(i * 1.0, i * 1.0 + 1.0, 8192, 1.0) for i in range(10)]
    rec = {"kind": "lm_train", "window": (0.0, 10.0), "steps": steps}
    assert _read("train_tok_s", rec) == 8192.0
    stalled = steps[:5] + [(a + 5.0, b + 5.0, n, x) for a, b, n, x in steps[5:]]
    rec2 = {"kind": "lm_train", "window": (0.0, 15.0), "steps": stalled}
    assert abs(_read("train_tok_s", rec2) - 8192 * 10 / 15.0) < 1e-9


class _Ev:
    """A raw profiler event as torch's kineto results give it."""

    def __init__(self, name, dev, start_s, dur_s, note=False):
        self._n, self._d, self._s, self._t, self._note = name, dev, start_s, dur_s, note

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(round(self._s * 1e9))

    def duration_ns(self):
        return int(round(self._t * 1e9))

    def is_user_annotation(self):
        return self._note


def test_trace_reduction_by_hand():
    from torch.autograd import DeviceType

    from benchmark.lib.trace import breakdown, reduce

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    tr = reduce([_Ev("aten::_int_mm", cpu, 0.0, 0.5),
                 _Ev("bench.stage.unit2text", cpu, 0.0, 4.0, note=True),
                 _Ev("gemm_s8_kernel", gpu, 1.0, 1.0), _Ev("copy", gpu, 1.5, 1.0),
                 _Ev("bench.stage.unit2text", gpu, 0.0, 4.0, note=True),
                 _Ev("cudaStreamSynchronize", cpu, 2.6, 0.9)])
    # the window spans every event (0 .. 4 s); the card was busy 1.0 .. 2.5 s
    assert abs(tr["window_s"] - 4.0) < 1e-9 and abs(tr["busy_s"] - 1.5) < 1e-9
    assert tr["device_ops"] == 2 and len(tr["host"]) == 3
    b = breakdown(tr)
    assert b["device_ops"][0][0] == "gemm_s8_kernel"
    # the longest idle gap (2.5 .. 4 s) is named by the shortest host event over its middle
    assert b["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert abs(b["idle_gaps"][0][1] - 1.5) < 1e-9


def test_engine_counter_readers():
    rec = {"kind": "dialog",
           "calm_stats": ({"steps": 100, "mixed_links": 10, "total_emitted": 500},
                          {"steps": 300, "mixed_links": 60, "total_emitted": 4500})}
    assert _read("rows_per_link.dialog", rec) == 20.0
    assert _read("mixed_share.dialog", rec) == 25.0

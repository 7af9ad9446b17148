"""The metric arithmetic: the end-to-end rates, the trace's reduction and
the per-layer readers, on runs and traces made by hand."""
import pytest

from benchmark import harness
from benchmark.metrics import k1_work


def _run(task="stream", trace=None, reruns=(False, True, False)):
    reqs = [harness.Request(k, 1.0 + 2.0 * k, 3.0 + 2.0 * k, 10800, True,
                            {"sync_rerun": r}) for k, r in enumerate(reruns)]
    return harness.Run(task, 12.5, 1.0, reqs, {"graph_captures": 0}, trace)


def test_frames_per_s_over_the_window():
    run = _run()
    # three arcs of 10800 frames, the last done 6 s after the start
    assert run.frames_per_s() == pytest.approx(3 * 10800 / 6.0)
    assert harness.load_metric("stream_frames_per_s").read(run) == \
        pytest.approx(5400.0)
    assert harness.load_metric("sim_frames_per_s").read(run) is None
    assert harness.load_metric("sim_frames_per_s").read(
        _run("simulate")) == pytest.approx(5400.0)
    assert harness.load_metric("setup_s").read(run) == 12.5


def test_failed_requests_do_not_count():
    run = _run()
    run.requests[2] = run.requests[2]._replace(ok=False)
    assert run.frames_per_s() == pytest.approx(2 * 10800 / 4.0)


def test_counters():
    run = _run()
    assert harness.load_metric("sync_reruns.stream").read(run) == 1
    assert harness.load_metric("graph_captures.stream").read(run) == 0


class _Ev:
    def __init__(self, name, s, e, dev=False, kind="kernel", tid=1):
        self._n, self._s, self._e, self._d, self._k, self._t = (
            name, s, e, dev, kind, tid)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d else DeviceType.CPU

    def activity_type(self):
        return self._k if self._d else "cpu_op"

    def start_thread_id(self):
        return self._t


def _trace():
    ns = 1_000_000  # 1 ms
    events = [
        _Ev("bench.traced", 0, 100 * ns),
        _Ev("bench.request", 1, 100 * ns - 1),
        _Ev("cudaMemcpyAsync", 10 * ns, 30 * ns),
        _Ev("cudaGraphLaunch", 50 * ns, 52 * ns),
        _Ev("pcr_solve<double>", 20 * ns, 40 * ns, dev=True),
        _Ev("other_kernel", 30 * ns, 50 * ns, dev=True),
        _Ev("Memcpy HtoD", 60 * ns, 70 * ns, dev=True, kind="gpu_memcpy"),
        _Ev("late_kernel", 95 * ns, 130 * ns, dev=True),
    ]
    return harness.reduce_trace(events, "bench.traced", 2,
                                [(9, 448, "float64")] * 2)


def test_reduce_trace_busy_idle_and_names():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    # busy: 20-50, 60-70, 95-100 ms (clipped to the span)
    assert t.busy_s == pytest.approx(0.045)
    # kernels: 20 + 20 + 5 ms (the copy is no kernel; overlaps add)
    assert t.kernel_s == pytest.approx(0.045)
    assert t.kernels["pcr_solve<double>"] == [pytest.approx(0.02), 1]
    idle = dict(t.idle_gaps)
    # gaps 0-20 (host in a copy at 10 ms), 50-60, 70-95
    assert idle["bench.request / cudaMemcpyAsync"] == pytest.approx(0.02)
    assert idle["bench.request"] == pytest.approx(0.035)
    assert {n for n, _ in t.device_ops[:2]} == {"other_kernel",
                                                "pcr_solve<double>"}
    # the runtime calls of the span's thread inside the span
    assert t.host_calls == {"cudaMemcpyAsync": 1, "cudaGraphLaunch": 1}


def test_per_layer_readers_on_a_trace():
    run = _run(trace=_trace())
    # three kernels and one graph launch over the trace's two requests
    assert harness.load_metric("kernels_per_arc.stream").read(run) == \
        pytest.approx(3 / 2)
    assert harness.load_metric("graph_launches_per_arc.stream").read(
        run) == pytest.approx(1 / 2)
    least = 2 * k1_work.min_seconds(9, 448, "float64")
    assert harness.load_metric("k1_roofline").read(run) == \
        pytest.approx(100 * least / 0.02)


def test_readers_find_nothing_without_a_trace():
    run = _run()
    for m in ("kernels_per_arc.stream", "graph_launches_per_arc.stream",
              "k1_roofline", "kernels_per_arc.sim",
              "graph_launches_per_arc.sim"):
        assert harness.load_metric(m).read(run) is None

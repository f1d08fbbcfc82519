"""The readers of the port's spans (mvsbench/spans.py and the metrics that
use it) on hand-made traces whose launches, synchronisations, host time
and idle time inside each span are known."""

from types import SimpleNamespace

import pytest

from mvsbench.cells import Cell, load_metric
from mvsbench.common import Readings
from mvsbench.trace import UNIT, Trace

SPAN_METRICS = ["infer.h2d_ms.serve", "model.host_ms.serve", "infer.wait_ms.serve",
                "nn.cost_volume_ms.serve", "model.launches.serve", "train.h2d_ms.train",
                "train.forward_ms.train", "train.backward_ms.train",
                "train.optimizer_ms.train", "train.loss_device_ms.train",
                "device.idle_ms.forward.train", "device.idle_ms.backward.train",
                "step.launches.train", "step.syncs.train"]


class Events:
    """A Chrome trace as torch.profiler exports it, built by hand (us)."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def span(self, name, a, b, tid=1):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name,
                            "ts": a, "dur": b - a, "tid": tid})

    def call(self, name, ts, dur=2, tid=1, cat="cuda_runtime"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                            "tid": tid, "args": {"correlation": self.corr}})
        return self.corr

    def launch(self, ts, start, dur, tid=1, name="cudaLaunchKernel", kernel="k"):
        """A launch call at ts and its kernel running [start, start + dur)."""
        corr = self.call(name, ts, tid=tid)
        self.events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": start,
                            "dur": dur, "tid": 7, "args": {"correlation": corr}})

    def readings(self, batch=1):
        cell = SimpleNamespace(traffic={"batch": batch})
        return Readings(cell, Trace(self.events), flops=0.0, host={})


def read(name, r):
    return load_metric(name).read(r)


def train_trace():
    """Two steps.  The profiler starts inside the first, so only the second
    has its batch wait and input copy: 80 us with three pageable copies,
    each a cudaMemcpyAsync and a cudaStreamSynchronize.  Step 1 launches
    four kernels in its forward (one through a runtime call that makes a
    driver call, counted once), one in its loss and three from the
    autograd thread (tid 2) in its backward, and ends on a
    cudaDeviceSynchronize; step 2 launches a cudaGraphLaunch in its forward,
    one kernel in its loss and two in its backward.  Forward 1's kernels
    cover 150 of its 280 us; forward 2's the whole of it."""
    e = Events()
    e.span(UNIT, 100, 1100)
    e.span("train.step", 110, 1090)
    e.span("train.forward", 120, 400)
    e.launch(130, 150, 100)
    e.launch(140, 300, 50)
    e.launch(150, 355, 0)
    e.launch(160, 352, 0)
    e.call("cuLaunchKernel", 161, dur=1, cat="cuda_driver")  # inside the call at 160
    e.span("train.loss", 400, 500)
    e.launch(410, 420, 40)
    e.span("train.backward", 500, 900)
    for ts in (510, 520, 530):
        e.launch(ts, 600, 100, tid=2)
    e.span("train.optimizer", 900, 1080)
    e.call("cudaDeviceSynchronize", 1085)
    e.span("train.batch_wait", 1102, 1110)
    e.span("train.h2d", 1110, 1190)
    for ts in (1120, 1140, 1160):
        e.call("cudaMemcpyAsync", ts)
        e.call("cudaStreamSynchronize", ts + 5)
    e.launch(1170, 1175, 5)  # a launch in the copy, outside the step
    e.span(UNIT, 1200, 2200)
    e.span("train.step", 1210, 2190)
    e.span("train.forward", 1220, 1500)
    e.launch(1225, 1220, 280, name="cudaGraphLaunch")
    e.span("train.loss", 1500, 1600)
    e.launch(1510, 1520, 40)
    e.span("train.backward", 1600, 2000)
    for ts in (1610, 1620):
        e.launch(ts, 1700, 100, tid=2)
    e.span("train.optimizer", 2000, 2180)
    return e


def test_train_readers():
    r = train_trace().readings()
    assert r.units == 2
    assert read("train.h2d_ms.train", r) == pytest.approx(0.080)
    assert read("train.forward_ms.train", r) == pytest.approx(0.280)
    assert read("train.backward_ms.train", r) == pytest.approx(0.400)
    assert read("train.optimizer_ms.train", r) == pytest.approx(0.180)
    assert read("train.loss_device_ms.train", r) == pytest.approx(0.040)
    # forward 1: 280 us less its busy 150 (two zero-length kernels add none)
    assert read("device.idle_ms.forward.train", r) == pytest.approx(0.130 / 2)
    # backward 1: [600, 700) busy of [500, 900); backward 2: [1700, 1800) of [1600, 2000)
    assert read("device.idle_ms.backward.train", r) == pytest.approx(0.300)
    # step 1: 4 + 1 + 3, step 2: one graph + 1 + 2
    assert read("step.launches.train", r) == pytest.approx((8 + 4) / 2)
    # three in the one traced copy; one in step 1, none in step 2
    assert read("step.syncs.train", r) == pytest.approx(3 + 1 / 2)


def serve_trace():
    """Two chunks of two views: copy in, forward (two cost-volume spans,
    each launching a 30 us and a 10 us kernel; five launches in all, one of
    them outside the model's range), wait."""
    e = Events()
    for base in (0, 1000):
        e.span("infer.h2d", base + 10, base + 70)
        e.span("infer.forward", base + 100, base + 500)
        e.span(UNIT, base + 110, base + 480)
        for cv in (150, 300):
            e.span("mvs.cost_volume", base + cv, base + cv + 50)
            e.launch(base + cv + 5, base + cv + 10, 30)
            e.launch(base + cv + 10, base + cv + 45, 10)
        e.launch(base + 490, base + 495, 5)
        e.span("infer.wait", base + 600, base + 900)
    return e


def test_serve_readers():
    r = serve_trace().readings(batch=2)
    assert r.units == 2
    assert read("infer.h2d_ms.serve", r) == pytest.approx(0.060 / 2)
    assert read("model.host_ms.serve", r) == pytest.approx(0.400 / 2)
    assert read("infer.wait_ms.serve", r) == pytest.approx(0.300 / 2)
    assert read("nn.cost_volume_ms.serve", r) == pytest.approx(0.080 / 2)
    assert read("model.launches.serve", r) == pytest.approx(5 / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_spans_reads_nothing(name):
    """The parent of the spans: units, kernels and launches, no span."""
    e = Events()
    e.span(UNIT, 0, 100)
    e.launch(10, 20, 30)
    e.call("cudaStreamSynchronize", 60)
    assert read(name, e.readings()) is None
    assert read(name, Readings(SimpleNamespace(traffic={"batch": 1}), None, 0.0, {})) is None


@pytest.mark.parametrize("kernel, cell, kernel_name", [
    ("k1", "dtu-test-serve", "warp_correlate_kernel"),
    ("k2", "dtu-mid-train", "warp_gather_kernel"),
    ("k3", "dtu-mid-train", "warp_scatter_kernel"),
    ("k4", "blendedmvs-train", "sinkhorn_fwd_4"),
    ("k5", "blendedmvs-train", "sinkhorn_bwd_4"),
])
def test_a_roofline_is_its_least_time_over_its_kernels_time(kernel, cell, kernel_name):
    """Two units whose kernels of that name run 300 and 100 us, beside
    another kernel: the share is the reader's own least seconds over 200 us
    a unit; without those kernels it reads nothing."""
    e = Events()
    e.span(UNIT, 0, 1000)
    e.span(UNIT, 1000, 2000)
    e.launch(10, 20, 300, kernel=kernel_name)
    e.launch(1010, 1020, 100, kernel=kernel_name)
    e.launch(1100, 1200, 50, kernel="other_kernel")
    metric = load_metric(f"{kernel}_roofline")
    least = metric.least_s(Cell(cell))
    assert least > 0
    r = Readings(Cell(cell), Trace(e.events), flops=0.0, host={})
    assert metric.read(r) == pytest.approx(100.0 * least / 200e-6)
    e = Events()
    e.span(UNIT, 0, 1000)
    e.launch(10, 20, 300, kernel="other_kernel")
    assert metric.read(Readings(Cell(cell), Trace(e.events), flops=0.0, host={})) is None

"""The span tracer (v2v_tpu_torch/utils/timers.py): spans off cost no
event and no clock read; spans on record each enter and exit in order on
the host's Unix clock, which torch.profiler's ranges share; a snapshot's
step, lead and allocation arithmetic, over the steps since the last
snapshot; the train step's seven ranges unchanged; the harness's CPU
`--trace 1` run."""
import json
import time
from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from v2v_bench import cell as cellmod
from v2v_bench.run import result
from v2v_bench.tests.small import CPU, train_cell
from v2v_bench.traffic import train as train_kind
from v2v_tpu_torch.ops.voxel import SimConfig
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.training.optim import Adam
from v2v_tpu_torch.training.raft import random_teacher
from v2v_tpu_torch.training.steps import make_train_step
from v2v_tpu_torch.utils import timers
from v2v_tpu_torch.utils.timers import BEGIN, ENTER, EXIT

STAGES = ["v2v.synthesize", "v2v.teacher", "v2v.forward", "v2v.loss",
          "v2v.backward", "v2v.all_reduce", "v2v.optimizer"]


@pytest.fixture(autouse=True)
def _tracer_off():
    timers.trace_off()
    yield
    timers.trace_off()


def _tiny_step():
    """The flagship's step on the simulator path at a tiny E2VID (width
    4), 16x16 clips of 11 frames, 2 teacher refinements."""
    cfg = {"loss": dict(chip_smoke.FLAGSHIP_MODULE["loss"],
                        temporal_consistency_L0=1, raft_num_flow_updates=2),
           "model": {"target": "model.model.E2VIDRecurrent",
                     "params": {"unet_kwargs": dict(
                         chip_smoke.FLAGSHIP_MODULE["model"]["params"]
                         ["unet_kwargs"], base_num_channels=4,
                         num_residual_blocks=1)}}}
    port = ModelInterface(cfg, device="cpu", teacher=random_teacher(2, "cpu"))
    step = make_train_step(port, Adam(lr=1e-4).make(port.model.parameters()),
                           SimConfig())
    g = torch.Generator().manual_seed(0)
    video = torch.randint(0, 256, (2, 2 * 5 + 1, 16, 16), dtype=torch.uint8,
                          generator=g)
    return lambda: step({"video": video}, g)


def _folded(monkeypatch):
    """The records [(name, kind, host ns, device ns)] of each step the
    tracer folds, in order."""
    seen, fold = [], timers.fold_step

    def spy(recs, *a):
        seen.append(recs)
        return fold(recs, *a)
    monkeypatch.setattr(timers, "fold_step", spy)
    return seen


def _ranges(prof):
    """(start ns, end ns, name) of the profiler's `v2v.` ranges."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("v2v."))


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_spans_off_create_no_event_and_read_no_clock(monkeypatch):
    step = _tiny_step()

    def banned(*a, **k):
        raise AssertionError("the tracer is off")

    monkeypatch.setattr(timers, "time", SimpleNamespace(
        time_ns=banned, perf_counter=banned, perf_counter_ns=banned,
        monotonic=banned))
    monkeypatch.setattr(torch.cuda, "Event", banned)
    monkeypatch.setattr(torch.cuda, "synchronize", banned)
    loss, _ = step()
    assert torch.isfinite(loss)
    with timers.span("v2v.x"):
        pass
    assert timers.snapshot() is None


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_spans_on_record_each_enter_and_exit_in_order(monkeypatch):
    step = _tiny_step()
    folded = _folded(monkeypatch)
    timers.trace_on("cpu")
    for _ in range(3):
        step()
    snap = timers.snapshot()
    # the third step is open: the next begin mark closes it
    assert snap["steps"] == 2 and len(folded) == 2
    want = [("step", BEGIN)] + [(n, k) for n in STAGES
                                for k in (ENTER, EXIT)]
    for recs in folded:
        assert [(n, k) for n, k, _, _ in recs] == want
        hosts = [h for _, _, h, _ in recs]
        assert hosts == sorted(hosts)
        # on the CPU the stream's time is the host's
        assert all(h == d for _, _, h, d in recs)
    assert sorted(snap["spans"]) == sorted(STAGES)
    assert all(v["count"] == 2 for v in snap["spans"].values())
    spans_ms = sum(v["stream_ms"] for v in snap["spans"].values())
    assert snap["step_stream_ms"] >= spans_ms
    assert snap["launch_lead_ms"] == 0.0 and snap["tracer_us"] > 0
    assert snap["device_allocs"] is None     # no caching allocator here
    timers.trace_off()
    assert timers.snapshot() is None


def test_a_second_snapshot_covers_only_the_new_steps():
    def step(ms):
        timers.step_begin()
        with timers.span("v2v.a"):
            time.sleep(ms / 1e3)

    timers.trace_on("cpu")
    for _ in range(3):
        step(1)
    first = timers.snapshot()
    assert first["steps"] == 2 and first["spans"]["v2v.a"]["count"] == 2
    for _ in range(3):
        step(8)
    second = timers.snapshot()
    # the first snapshot's open step and two of the 8 ms steps; the
    # median over every step since trace_on would read 1 ms
    assert second["steps"] == 3 and second["spans"]["v2v.a"]["count"] == 3
    assert second["spans"]["v2v.a"]["host_ms"] >= 8
    assert second["step_stream_ms"] >= 8
    empty = timers.snapshot()
    assert empty["steps"] == 0 and empty["spans"] == {}
    assert empty["step_stream_ms"] is None


def _rec(name, kind, host_us, dev_us):
    return (name, kind, int(host_us * 1e3), dev_us * 1e3)


def test_fold_step_gives_stream_spans_and_the_smallest_lead():
    # the host launches ahead; the card is 400 us behind at the forward's
    # enter and catches up to 20 us at the loss's exit
    recs = [_rec("step", BEGIN, 0, 500), _rec("v2v.forward", ENTER, 10, 410),
            _rec("v2v.inner", ENTER, 20, 900),
            _rec("v2v.inner", EXIT, 30, 1000),
            _rec("v2v.forward", EXIT, 40, 3040),
            _rec("v2v.loss", ENTER, 3100, 3200),
            _rec("v2v.loss", EXIT, 3500, 3520)]
    step = timers.fold_step(recs, close_dev=4500 * 1e3, cost_ns=7000)
    assert step["stream_ms"] == pytest.approx(4.0)
    fwd, inner, loss = (step["spans"][k] for k in ("v2v.forward",
                                                   "v2v.inner", "v2v.loss"))
    assert fwd == [1, pytest.approx(0.03), pytest.approx(2.63)]
    assert inner == [1, pytest.approx(0.01), pytest.approx(0.1)]
    assert loss == [1, pytest.approx(0.4), pytest.approx(0.32)]
    # the lead and the device ns where it fell (the loss's exit)
    assert step["lead"] == (pytest.approx(20e3), pytest.approx(3520e3))
    assert step["cost_ns"] == 7000
    # an exit without its enter (the tracer turned on inside) is skipped
    half = timers.fold_step(recs[:1] + recs[2:], close_dev=4500 * 1e3)
    assert "v2v.forward" not in half["spans"]


def test_summarize_takes_medians_and_corrects_the_lead_for_drift():
    def step(stream, fwd, lead_us, at_us):
        return {"stream_ms": stream, "cost_ns": 40e3,
                "spans": {"v2v.forward": [1, 0.2, fwd]},
                "lead": (lead_us * 1e3, at_us * 1e3)}

    anchor = 1e6                    # us
    steps = [step(500, 120, 30, 2e6), step(510, 130, 10, 4e6),
             step(490, 125, 50, 6e6)]
    # the card's clock runs 10 ppm slow against the host's: 1, 3 and 5 s
    # past the anchor a raw lead reads 10, 30 and 50 us short
    snap = timers.summarize(steps, 0.5, 1 + 10e-6, anchor * 1e3)
    assert snap["steps"] == 3 and snap["step_stream_ms"] == 500
    assert snap["spans"]["v2v.forward"] == {
        "count": 3, "host_ms": pytest.approx(0.2), "stream_ms": 125}
    # leads corrected: 30 + 10, 10 + 30, 50 + 50 us
    assert snap["launch_lead_ms"] == pytest.approx(0.040, abs=1e-6)
    assert snap["tracer_us"] == pytest.approx(40)
    assert snap["device_allocs"] == 0.5
    assert set(snap) == {"steps", "step_stream_ms", "spans",
                         "launch_lead_ms", "device_allocs", "tracer_us"}


def test_records_before_the_first_step_and_after_its_last_span():
    timers.trace_on("cpu")
    with timers.span("v2v.loader_wait"):
        time.sleep(0.002)
    timers.step_begin()
    with timers.span("v2v.forward"):
        pass
    with timers.span("v2v.loader_wait"):
        pass
    timers.step_begin()
    snap = timers.snapshot()
    # the wait before the first step is dropped; the one after the
    # step's spans belongs to it
    assert snap["steps"] == 1
    assert snap["spans"]["v2v.loader_wait"]["count"] == 1
    assert snap["spans"]["v2v.forward"]["count"] == 1


def test_span_enter_shares_the_profilers_clock(monkeypatch):
    def work():
        for _ in range(3):
            timers.step_begin()
            for name in ("v2v.a", "v2v.b"):
                with timers.span(name):
                    time.sleep(0.003)
        timers.step_begin()

    with profile(activities=[ProfilerActivity.CPU]):
        work()                      # the profiler's first ranges are slow
    folded = _folded(monkeypatch)
    timers.trace_on("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    timers.snapshot()
    ranges = _ranges(prof)
    spans = [(h, n) for recs in folded for n, k, h, _ in recs
             if k == ENTER]
    exits = [h for recs in folded for _, k, h, _ in recs if k == EXIT]
    assert [n for _, n in spans] == [n for _, _, n in ranges]
    for (enter, _), exit_, (start, end, _) in zip(spans, exits, ranges):
        assert abs(enter - start) < 1e6 and abs(exit_ - end) < 1e6


@pytest.mark.filterwarnings("ignore:LPIPS")
@pytest.mark.parametrize("traced", [False, True])
def test_a_step_under_the_profiler_shows_the_seven_ranges(traced):
    step = _tiny_step()
    step()
    if traced:
        timers.trace_on("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        step()
    ranges = _ranges(prof)
    assert [n for _, _, n in ranges] == STAGES * 2
    for (_, end, _), (start, _, _) in zip(ranges, ranges[1:]):
        assert end <= start         # none nested in another


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_the_harness_cpu_traced_run_prints_its_line():
    c = train_cell("e2vid.train", float32=True)
    c = c._replace(spec=cellmod.from_files("e2vid.train").spec)
    out = train_kind.run(c, 2 ** 31 + 12345, 0.0, True, CPU, lambda: 0.0,
                         train_kind.LOOKS["float32_teacher"])
    line = json.loads(json.dumps(result(c, out, True, CPU)))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    # no kernel runs on the CPU, so the span metrics read nothing here
    assert {"mfu.train", "idle_share.train"} <= set(line["metrics"])


class _FakeDriver:
    """libcuda's event calls on a card whose clock (`now`, ns) and
    progress (`passed`: the events it has reached up to that time) the
    test sets."""

    def __init__(self):
        self.events, self.made, self.streams = {}, 0, []
        self.now = self.passed = 0

    def cuEventCreate(self, ev, flags):
        self.made += 1
        ev.value = 4096 + self.made
        self.events[ev.value] = None
        return 0

    def cuEventRecord(self, ev, stream):
        self.streams.append(stream)
        self.events[ev] = self.now
        return 0

    def cuEventQuery(self, ev):
        return 0 if self.events[ev] <= self.passed else 600

    def cuEventSynchronize(self, ev):
        self.passed = max(self.passed, self.events[ev])
        return 0

    def cuEventElapsedTime(self, ms, a, b):
        ms._obj.value = (self.events[b] - self.events[a]) / 1e6
        return 0

    def cuEventDestroy_v2(self, ev):
        del self.events[ev]
        return 0


def test_the_card_path_against_a_fake_driver(monkeypatch):
    """The events' path without a card: each event is recorded on
    PyTorch's current stream, a pool that runs dry refills from the steps
    the card has passed, the stream times are the events', and trace_off
    gives every event back."""
    import ctypes
    fake = _FakeDriver()
    # plain functions, which take ctypes' argtypes and restype
    lib = SimpleNamespace(**{name: (lambda f: lambda *a: f(*a))(
        getattr(fake, name)) for name in dir(fake) if name.startswith("cu")})
    monkeypatch.setattr(ctypes, "CDLL", lambda name: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 77, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    stats = {"num_device_alloc": 7, "num_alloc_retries": 1}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: dict(stats))
    monkeypatch.setattr(timers, "POOL_EVENTS", 6)
    timers.trace_on(torch.device("cuda", 0))

    def steps(n, allocs):
        for _ in range(n):
            timers.step_begin()
            with timers.span("v2v.forward"):
                fake.now += 3_000_000           # 3 ms of the card's work
                stats["num_device_alloc"] += allocs
            fake.now += 1_000
            fake.passed = fake.now          # the card catches up
    steps(5, 2)
    timers.step_begin()
    fake.now += 2_000
    snap = timers.snapshot()
    assert snap["steps"] == 5 and set(fake.streams) == {77}
    # 3 records a step: the pool of 6 refilled from the passed steps
    assert fake.made < 5 * 3
    assert snap["spans"]["v2v.forward"]["stream_ms"] == pytest.approx(3.0)
    assert snap["step_stream_ms"] == pytest.approx(3.001)
    assert snap["device_allocs"] == 2.0
    # the next snapshot counts from this one
    steps(4, 0)
    snap = timers.snapshot()
    assert snap["steps"] == 4 and snap["device_allocs"] == 0.0
    timers.trace_off()
    assert not fake.events


@pytest.mark.cuda
def test_the_tracer_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events have no CPU mode")
    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)
    (x @ x).sum().item()
    folded = _folded(monkeypatch)
    timers.trace_on(dev)
    for _ in range(4):
        timers.step_begin()
        with timers.span("v2v.forward"):
            for _ in range(10):
                y = x @ x
        with timers.span("v2v.loss"):
            torch.cuda._sleep(1_000_000)     # ~0.5 ms of spinning
    timers.step_begin()
    torch.cuda.synchronize()
    snap = timers.snapshot()
    timers.trace_off()
    assert snap["steps"] == 4 and y.isfinite().all()
    fwd, loss = snap["spans"]["v2v.forward"], snap["spans"]["v2v.loss"]
    # the host queues ten 4096^3 matmuls in far less than they take
    assert fwd["stream_ms"] > 3 * fwd["host_ms"]
    assert loss["stream_ms"] > 0.1
    assert snap["step_stream_ms"] >= fwd["stream_ms"] + loss["stream_ms"]
    assert snap["launch_lead_ms"] >= -0.1
    assert snap["device_allocs"] >= 0
    assert len(folded) == 4
    for recs in folded:
        devs = [d for _, _, _, d in recs]
        assert devs == sorted(devs)

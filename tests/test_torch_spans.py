"""The port's span recorder (``utils/profiling.py``) and the spans of the
forecast service and the rollout.

Spans are off by default and then cost one test; a request's spans form
one tree per request (the root ``service.ensemble`` or
``service.forecast``), each span inside its parent's interval, on the
clock of ``torch.profiler``'s events.  Recording changes no answer.
"""

import threading
import time

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.serve import ForecastService
from dlwp_cs_tpu_torch.utils import profiling
from dlwp_cs_tpu_torch.utils.profiling import NO_SPAN, record_spans, span

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}
STEPS, MEMBERS = 3, 5
ENSEMBLE_CHILDREN = ["service.prepare", "rollout.build", "rollout.enqueue", "service.wait",
                     "service.copy_back", "service.denormalise"]


@pytest.fixture(scope="module")
def served():
    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4, 8)))
    est = DLWPEstimator(cfg, device="cpu", seed=3).load_state(STATS)
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(3, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    return est, const, windows


def _ensemble(svc, window, t0=9668.5):
    return svc.forecast_ensemble(window, t0, steps=STEPS, members=MEMBERS, amplitude=0.05)


def _children(spans, sp):
    return sorted((s for s in spans if s.parent == sp.id), key=lambda s: s.start_ns)


def _check_tree(spans, root, want_children):
    """``root``'s request: its children in order, ``STEPS`` model calls
    under ``rollout.enqueue``, every span inside its parent and carrying
    the root's request id."""
    mine = [s for s in spans if s.request == root.id]
    assert root.parent is None and root.request == root.id
    assert [c.name for c in _children(spans, root)] == want_children
    (enq,) = [c for c in _children(spans, root) if c.name == "rollout.enqueue"]
    calls = _children(spans, enq)
    assert [c.name for c in calls] == ["rollout.call"] * STEPS
    by_id = {s.id: s for s in mine}
    assert len(mine) == 1 + len(want_children) + STEPS
    for s in mine:
        assert s.start_ns <= s.end_ns
        assert s.thread == root.thread
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # siblings do not overlap
    kids = _children(spans, root)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns


def test_spans_are_off_by_default(served, monkeypatch):
    est, const, windows = served
    assert profiling._recording is None
    assert span("service.ensemble", batch=1) is NO_SPAN

    def no_clock():
        raise AssertionError("a span read the clock while nothing records")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with span("rollout.call") as got:
        assert got is None
    monkeypatch.undo()
    svc = ForecastService(est, constants=const)
    _ensemble(svc, windows[0])  # made outside any recording: not recorded
    with record_spans() as spans:
        assert spans == []
    assert spans == []


def test_recorder_nesting_threads_and_errors():
    def worker():
        with span("w.root"):
            with span("w.child"):
                pass

    with record_spans() as spans:
        with pytest.raises(RuntimeError, match="already"):
            with record_spans():
                pass
        with span("a", k=1) as a:
            with span("b"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
            with pytest.raises(ValueError):
                with span("c"):
                    raise ValueError("recorded all the same")
        left_open = span("open")
        left_open.__enter__()
    assert not th.is_alive()
    assert a is not None
    by_name = {s.name: s for s in spans}
    assert set(by_name) == {"a", "b", "c", "w.root", "w.child"}
    assert by_name["a"].attrs == {"k": 1} and by_name["a"].parent is None
    assert by_name["b"].parent == by_name["c"].parent == by_name["a"].id
    assert {by_name[k].request for k in "abc"} == {by_name["a"].id}
    # the worker's spans are a tree of their own, on their own thread
    assert by_name["w.root"].parent is None
    assert by_name["w.child"].parent == by_name["w.root"].id
    assert by_name["w.child"].request == by_name["w.root"].id
    assert by_name["w.root"].thread != by_name["a"].thread
    assert len({s.id for s in spans}) == len(spans)
    assert profiling._recording is None and span("x") is NO_SPAN


@pytest.mark.parametrize("kind", ["ensemble", "forecast"])
def test_answers_equal_with_spans_on_and_off(served, kind):
    est, const, windows = served
    svc = ForecastService(est, constants=const)

    def run():
        if kind == "ensemble":
            fc = _ensemble(svc, windows[:2], [9668.5, 9670.0])
            return fc.mean, fc.spread, fc.lead_hours
        fc = svc.forecast(windows[:2], [9668.5, 9670.0], steps=STEPS)
        return fc.fields, fc.lead_hours

    off = run()
    with record_spans() as spans:
        on = run()
    assert spans
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert svc.stats.dispatch_seconds > 0


def test_ensemble_request_is_one_tree(served):
    est, const, windows = served
    svc = ForecastService(est, constants=const)
    with record_spans() as spans:
        _ensemble(svc, windows[0])
        _ensemble(svc, windows[1:3], [9668.5, 9669.0])
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [r.name for r in roots] == ["service.ensemble"] * 2
    assert roots[0].attrs == {"batch": 1, "members": MEMBERS, "steps": STEPS}
    assert roots[1].attrs["batch"] == 2
    assert roots[0].end_ns <= roots[1].start_ns
    for root in roots:
        # the service builds a forecaster, so a rollout, for every request
        _check_tree(spans, root, ENSEMBLE_CHILDREN)
    assert len(spans) == 2 * (1 + len(ENSEMBLE_CHILDREN) + STEPS)


def test_forecast_request_builds_its_rollout_once(served):
    est, const, windows = served
    svc = ForecastService(est, constants=const)
    with record_spans() as spans:
        svc.forecast(windows[0], 9668.5, steps=STEPS)
        svc.forecast(windows[1], 9669.0, steps=STEPS, normalized=True)
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [r.name for r in roots] == ["service.forecast"] * 2
    assert roots[0].attrs == {"batch": 1, "steps": STEPS}
    _check_tree(spans, roots[0], ENSEMBLE_CHILDREN)
    # the estimator keeps the rollout; normalized answers are not denormalised
    _check_tree(spans, roots[1], ["service.prepare", "rollout.enqueue", "service.wait",
                                  "service.copy_back"])


def test_submit_ensemble_spans_on_the_worker_thread(served):
    est, const, windows = served
    svc = ForecastService(est, constants=const, max_batch=4, max_wait_ms=0.0)
    try:
        with record_spans() as spans:
            direct = _ensemble(svc, windows[0])
            fut = svc.submit_ensemble(windows[1], 9669.0, steps=STEPS, members=MEMBERS)
            fut.result(timeout=120)
    finally:
        svc.close()
    assert direct.mean.shape[0] == 1
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [r.name for r in roots] == ["service.ensemble"] * 2
    main, worker = roots
    assert main.thread == threading.get_ident()
    assert worker.thread != main.thread
    assert worker.request != main.request
    assert worker.attrs == {"batch": 1, "members": MEMBERS, "steps": STEPS}
    for root in roots:
        _check_tree(spans, root, ENSEMBLE_CHILDREN)


def test_spans_share_the_profiler_clock():
    a = torch.randn(192, 192)
    torch.mm(a, a)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_spans() as spans:
            time.sleep(0.002)
            with span("mm"):
                torch.mm(a, a)
            time.sleep(0.002)
    (sp,) = spans
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    tol = 50_000  # ns
    assert sp.start_ns - tol <= start and end <= sp.end_ns + tol
    # and the span is not loose around it: the sleeps lie outside
    assert sp.end_ns - sp.start_ns < 2_000_000

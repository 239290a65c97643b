"""The port's stage recorder on the /v1/infer path, on the CPU: the
coalescer's dispatch stages tile its thread's time, blocked time shows as
wall less CPU, each forward is marked on the device's clock (the host
clock for a forward on the host), the batcher's counters are exact and
cumulative across swaps, the front end's parse and respond are counted
once a request, and with tracing off nothing is recorded and nothing that
records is called.  Under the app's own profile capture the stages are
ranges on the dispatch thread, and under no other session."""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Ensemble, EnsembleMember, ModelRegistry
from repro_torch.core.batching import BucketSpec
from repro_torch.core.telemetry import Stages
from repro_torch.serving import FlexServeApp, FlexServeClient, FlexServeServer
from repro_torch.serving import coalesce as co
from repro_torch.serving.server import INFER_STAGES
from repro_torch.serving.telemetry import (all_threads_config,
                                           prometheus_exposition)


def _member(name, seed=0):
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(seed))

    def apply(p, batch):
        return batch["x"].float() @ p["w"]
    return EnsembleMember(name, apply, {"w": w}, 3)


def _ensemble(max_batch=4):
    return Ensemble([_member("a", 0), _member("b", 1)], max_batch=max_batch)


def _rows(n, v=1.0):
    return {"x": np.full((n, 4), v, np.float32)}


def _submit_all(coalescer, sizes, **kw):
    """Submit one request per size, each from its own thread; returns the
    results in order."""
    out = [None] * len(sizes)

    def go(i, n):
        out[i] = coalescer.submit(_rows(n, float(i)), **kw)
    ts = [threading.Thread(target=go, args=(i, n))
          for i, n in enumerate(sizes)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def _wall(snap, name):
    return snap[name]["wall_ms_hist"]["sum"]


def _count(snap, name):
    return snap[name]["wall_ms_hist"]["count"]


# --- the recorder ------------------------------------------------------------


def test_a_clock_switches_stages_with_no_gap():
    st = Stages(("a", "b", "c"))
    assert {k: (v["wall_ms_hist"]["count"], v["cpu_ms"])
            for k, v in st.snapshot().items()} == dict.fromkeys("abc",
                                                                (0, 0.0))
    clk = st.clock()
    assert st.clock() is clk
    t0 = time.perf_counter()
    clk.switch("a")
    time.sleep(0.02)
    clk.switch("b")
    time.sleep(0.01)
    clk.stop()
    t1 = time.perf_counter()
    clk.stop()                                 # nothing open: no-op
    snap = st.snapshot()
    assert _count(snap, "a") == _count(snap, "b") == 1
    assert _wall(snap, "a") >= 19.0 and _wall(snap, "b") >= 9.0
    assert _wall(snap, "a") + _wall(snap, "b") <= 1e3 * (t1 - t0)
    # sleeping costs no CPU time
    assert snap["a"]["cpu_ms"] < 5.0
    # a stage opened with an earlier start counts its wall time from it
    clk.switch("c", t=time.perf_counter() - 0.05)
    clk.stop()
    assert _wall(st.snapshot(), "c") >= 50.0


def test_threads_recording_into_one_stage_lose_nothing():
    """More threads than cores on a short switch interval: every
    observation lands (a lost update would drop a count)."""
    st = Stages(("s",))
    n_threads, n = 32, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def go():
            clk = st.clock()
            for _ in range(n):
                clk.switch("s")
            clk.stop()
        ts = [threading.Thread(target=go) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _count(st.snapshot(), "s") == n_threads * n


# --- the dispatch thread -----------------------------------------------------


@pytest.fixture
def long_idle_poll(monkeypatch):
    """No idle poll times out in the test (a loaded host may pause longer
    than the default poll between two requests), so every forward but the
    first has a gap."""
    monkeypatch.setattr(co, "IDLE_POLL_S", 30.0)


def test_dispatch_stages_tile_the_thread_wall_time(long_idle_poll):
    st = Stages(co.DISPATCH_STAGES)

    def fwd(batch):
        time.sleep(0.004)
        return {"y": torch.from_numpy(batch["x"]) * 2}
    t0 = time.perf_counter()
    c = co.BatchCoalescer(fwd, BucketSpec.pow2(8), max_wait_ms=2.0,
                          stages=st)
    try:
        # about two seconds: the thread's start and join take well under 1%
        for _ in range(32):
            _submit_all(c, [1, 2, 3, 1, 2])
            time.sleep(0.04)
    finally:
        c.close()
    t1 = time.perf_counter()
    assert not c._thread.is_alive()
    snap = st.snapshot()
    tiled = sum(_wall(snap, s) for s in co.DISPATCH_STAGES)
    assert 0.99 * 1e3 * (t1 - t0) <= tiled <= 1e3 * (t1 - t0)
    forwards = c.stats()["batches_formed"]
    for s in (co.MERGE, co.LAUNCH, co.SYNC, co.SCATTER):
        assert _count(snap, s) == forwards, s
    assert _wall(snap, co.LAUNCH) >= 4.0 * forwards
    # every forward on the host clock; a gap before each but the first
    assert c.stats()["device_forward_ms_hist"]["count"] == forwards
    assert c.stats()["device_gap_ms_hist"]["count"] == forwards - 1


def test_lingering_with_an_open_group_counts_as_linger():
    st = Stages(co.DISPATCH_STAGES)
    c = co.BatchCoalescer(lambda b: {"y": torch.from_numpy(b["x"])},
                          BucketSpec.pow2(4), max_wait_ms=120.0, stages=st)
    try:
        time.sleep(0.15)                       # no work: wait
        before = st.snapshot()
        # 3 rows fill no bucket exactly: the group lingers its full 120 ms
        c.submit(_rows(3))
        after = st.snapshot()
    finally:
        c.close()
    assert _wall(before, co.WAIT) >= 100.0
    assert _wall(before, co.LINGER) == 0.0
    lingered = _wall(after, co.LINGER) - _wall(before, co.LINGER)
    assert 100.0 <= lingered < 5000.0
    # waiting after the forward is wait again, never linger
    assert _wall(st.snapshot(), co.LINGER) == pytest.approx(
        _wall(after, co.LINGER))


def test_no_gap_is_recorded_across_an_idle_poll(monkeypatch):
    """The device waiting for requests is not a gap between forwards."""
    st = Stages(co.DISPATCH_STAGES)
    monkeypatch.setattr(co, "IDLE_POLL_S", 0.02)
    c = co.BatchCoalescer(lambda b: {"y": torch.from_numpy(b["x"])},
                          BucketSpec.pow2(4), max_wait_ms=1.0, stages=st)
    try:
        c.submit(_rows(1))
        time.sleep(0.3)                        # idle polls time out
        monkeypatch.setattr(co, "IDLE_POLL_S", 30.0)
        c.submit(_rows(1))
        gaps = c.stats()["device_gap_ms_hist"]["count"]
        c.submit(_rows(1))                     # no poll between: a gap
        after = c.stats()
    finally:
        c.close()
    assert gaps == 0
    assert after["device_gap_ms_hist"]["count"] == 1
    assert after["device_forward_ms_hist"]["count"] == 3


def _launch_once(how):
    """(stage wall, stage wall less CPU, the forward's own wall less CPU)
    ms of one forward's launch stage whose forward sleeps, or spins on its
    thread's CPU, for 50 ms."""
    st = Stages(co.DISPATCH_STAGES)
    own = []

    def fwd(batch):
        w0, c0 = time.perf_counter(), time.thread_time()
        if how == "sleep":
            time.sleep(0.05)
        else:
            while time.thread_time() - c0 < 0.05:
                pass
        own.append(1e3 * ((time.perf_counter() - w0)
                          - (time.thread_time() - c0)))
        return {"y": torch.from_numpy(batch["x"])}
    c = co.BatchCoalescer(fwd, BucketSpec.pow2(4), max_wait_ms=1.0,
                          stages=st)
    try:
        c.submit(_rows(1))
    finally:
        c.close()
    snap = st.snapshot()
    assert _count(snap, co.LAUNCH) == 1
    wall = _wall(snap, co.LAUNCH)
    return wall, wall - snap[co.LAUNCH]["cpu_ms"], own[0]


def test_blocked_time_in_launch_is_wall_less_cpu():
    wall, stalled, _ = _launch_once("sleep")
    assert wall >= 50.0 and stalled >= 45.0


def test_running_time_in_launch_is_not_stall():
    """A forward that runs shows no stall of the stage's own making: the
    stage's wall less CPU is what the forward itself lost to the host
    taking its core away (under 5 ms on an idle host; a loaded one, as
    under a parallel test run, may take tens), within 5 ms."""
    wall, stalled, own = _launch_once("spin")
    assert wall >= 50.0
    assert abs(stalled - own) < 5.0, (stalled, own)


# --- the batcher's counters -------------------------------------------------


@pytest.mark.parametrize("rows,padded", [(1, 0), (2, 0), (3, 1)])
def test_batcher_counts_a_forward_its_rows_and_padding(rows, padded):
    ens = _ensemble(max_batch=4)
    ens.forward(_rows(rows))
    assert ens.batch_counts == {"forwards": 1, "rows_total": rows,
                                "padded_rows_total": padded}


def test_batcher_counters_are_exact_when_coalesced_and_across_swaps():
    """1-, 2- and 3-row requests queued while a forward runs coalesce into
    bucket-4 forwards (two, in any arrival order)."""
    ens = _ensemble(max_batch=4)
    groups, entered, release = [], threading.Event(), threading.Event()

    def fwd(batch):
        groups.append(batch["x"].shape[0])
        if len(groups) == 1:                   # hold the dispatcher
            entered.set()
            assert release.wait(30)
        return ens.forward(batch)
    c = co.BatchCoalescer(fwd, ens.batch_buckets, max_wait_ms=50.0)
    try:
        holder = threading.Thread(target=c.submit, args=(_rows(1),))
        holder.start()
        assert entered.wait(30)
        queued = threading.Thread(target=_submit_all, args=(c, [1, 2, 3]))
        queued.start()
        deadline = time.monotonic() + 30
        while c.stats()["queue_depth_rows"] < 7:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        release.set()
        for t in (holder, queued):
            t.join(timeout=30)
            assert not t.is_alive()
        first = ens.batch_counts
        assert groups[0] == 1 and sorted(groups[1:]) in ([2, 4], [3, 3])
        buckets = ens.batch_buckets
        assert first == {
            "forwards": 3, "rows_total": 7,
            "padded_rows_total": sum(buckets.bucket_for(g) - g
                                     for g in groups)}
        ens.set_members([_member("a", 2), _member("b", 3)])
        assert ens.batch_counts == first        # the retired state's kept
        c.submit(_rows(3))
    finally:
        release.set()
        c.close()
    assert ens.batch_counts == {
        "forwards": 4, "rows_total": 10,
        "padded_rows_total": first["padded_rows_total"] + 1}


# --- the app: /metrics, the front end, tracing off ---------------------------


def _serve(trace):
    app = FlexServeApp(ModelRegistry(), _ensemble(max_batch=8), None,
                       trace=trace)
    srv = FlexServeServer(app).start()
    return app, srv, FlexServeClient(*srv.address, retries=0)


def _infer_concurrently(cl, sizes):
    host, port = cl.host, cl.port
    errs = []

    def go(n):
        c2 = FlexServeClient(host, port, retries=0)
        try:
            c2.infer({"x": np.ones((n, 4), np.float32).tolist()})
        except Exception as e:              # noqa: BLE001 — asserted below
            errs.append(e)
        finally:
            c2.close()
    ts = [threading.Thread(target=go, args=(n,)) for n in sizes]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs


def test_metrics_report_stages_device_marks_and_batches(long_idle_poll):
    app, srv, cl = _serve(trace=True)
    try:
        _infer_concurrently(cl, [1, 2, 3, 4, 1, 2])
        cl.detect({"x": np.ones((2, 4), np.float32).tolist()},
                  positive_class=1)
        m = cl.metrics()
    finally:
        cl.close()
        srv.stop()
    st, coal, batches = m["stages"], m["coalesce"], m["ensemble_batches"]
    assert set(st) == set(INFER_STAGES)
    forwards = coal["batches_formed"]
    assert batches["forwards"] == forwards and batches["rows_total"] == 15
    assert 0 <= batches["padded_rows_total"] < 8 * forwards
    assert coal["rows_total"] == 15
    # seven requests: each parsed once and answered once
    assert _count(st, co.PARSE) == _count(st, co.RESPOND) == 7
    assert _count(st, co.LAUNCH) == forwards
    assert coal["device_forward_ms_hist"]["count"] == forwards
    assert coal["device_gap_ms_hist"]["count"] == forwards - 1
    assert all(v["cpu_ms"] >= 0.0 for v in st.values())
    text = prometheus_exposition(m)
    assert "flexserve_stages_coalesce_launch_wall_ms_hist_count" in text
    assert "flexserve_stages_frontend_parse_cpu_ms" in text
    assert "flexserve_ensemble_batches_padded_rows_total" in text
    assert "flexserve_coalesce_device_gap_ms_hist_count" in text


def test_with_tracing_off_nothing_records_and_the_sections_are_zero(
        monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called with tracing off")
    app, srv, cl = _serve(trace=False)
    assert app.stages is None
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(time, "thread_time", boom)
    try:
        _infer_concurrently(cl, [1, 2, 3])
        m = cl.metrics()
    finally:
        monkeypatch.undo()
        cl.close()
        srv.stop()
    assert set(m["stages"]) == set(INFER_STAGES)
    assert all(v["wall_ms_hist"]["count"] == 0 and v["cpu_ms"] == 0.0
               for v in m["stages"].values())
    for h in ("device_forward_ms_hist", "device_gap_ms_hist"):
        assert m["coalesce"][h]["count"] == 0 and m["coalesce"][h]["sum"] == 0
    # the batcher's counters are always on
    assert m["ensemble_batches"]["rows_total"] == 6
    assert m["ensemble_batches"]["forwards"] == m["coalesce"]["batches_formed"]


def test_uncoalesced_route_splits_parse_and_respond():
    app = FlexServeApp(ModelRegistry(), _ensemble(max_batch=8), None,
                       coalesce=False)
    srv = FlexServeServer(app).start()
    cl = FlexServeClient(*srv.address, retries=0)
    try:
        for n in (1, 3):
            cl.infer({"x": np.ones((n, 4), np.float32).tolist()})
        m = cl.metrics()
    finally:
        cl.close()
        srv.stop()
    assert _count(m["stages"], co.PARSE) == _count(m["stages"],
                                                   co.RESPOND) == 2
    assert m["ensemble_batches"]["forwards"] == 2


def _flexserve_ranges(path):
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("flexserve.")]


def test_the_apps_capture_records_ranges_on_the_dispatch_thread(tmp_path):
    app = FlexServeApp(ModelRegistry(), _ensemble(max_batch=8), None,
                       profile_dir=str(tmp_path))
    srv = FlexServeServer(app).start()
    cl = FlexServeClient(*srv.address, retries=0)
    try:
        _infer_concurrently(cl, [1])
        art = cl.start_profile(duration_ms=600, mode="torch")["artifact"]
        deadline = time.monotonic() + 30
        while cl.profile_status()["active"] is not None:   # traffic
            assert time.monotonic() < deadline
            _infer_concurrently(cl, [1, 2, 3])
        assert cl.profile_status()["last"]["ok"]
        assert app.stages.ranges is False      # cleared after the capture
        tid = app.coalescer._thread.native_id
    finally:
        cl.close()
        srv.stop()
    events = _flexserve_ranges(Path(art) / "trace.json")
    on_dispatch = {e["name"] for e in events if e.get("tid") == tid}
    assert {"flexserve.coalesce.launch", "flexserve.coalesce.sync",
            "flexserve.coalesce.scatter"} <= on_dispatch
    assert on_dispatch <= {"flexserve." + s for s in co.DISPATCH_STAGES}
    # the handler threads' ranges are on other threads
    assert any(e["name"] == "flexserve.frontend.respond"
               and e.get("tid") != tid for e in events)


def test_a_session_started_outside_the_app_gets_no_ranges(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    app, srv, cl = _serve(trace=True)
    try:
        _infer_concurrently(cl, [1])
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=all_threads_config()) as prof:
            _infer_concurrently(cl, [1, 2, 3])
    finally:
        cl.close()
        srv.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert _flexserve_ranges(path) == []
    # the session saw the dispatch thread's work all the same
    assert any(e.get("name") == "aten::matmul" or e.get("name") == "aten::mm"
               for e in json.loads(path.read_text())["traceEvents"])

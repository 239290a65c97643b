"""The port's SLO autopilot, on the CPU: the contracts of
``tests/test_slo.py`` (sliding-window SLI math under synthetic time, the
usage ledger's conservation property against the scheduler's global
accumulators, burn-rate policy evaluation, controller promote/rollback
through fake actuators, the HTTP query surfaces and the end-to-end drill
on the port's engine), and the pure functions held against the JAX
package: the same synthetic observations give identical window and store
snapshots, usage rollups and controller decisions in both."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import slo as jslo
from repro.serving import FlightRecorder as JRecorder
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import InferenceEngine, ModelRegistry, SamplingParams
from repro_torch.core import slo as tslo
from repro_torch.core.scheduler import SchedulerService
from repro_torch.core.slo import (SLIStore, SLOController, SLOPolicy,
                                  SlidingWindow, UsageLedger, load_policies)
from repro_torch.models.build import build_model
from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                 FlexServeServer, FlightRecorder,
                                 HTTPStatusError, RequestContext)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers every
    worker's torch would start a thread per core (several times the run's
    CPU time for the same results)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "yi-9b"


@pytest.fixture(scope="module")
def engine():
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    return InferenceEngine(model, model.init(0, "cpu"), max_len=64,
                           max_batch=4)


# --- SlidingWindow: ring-of-buckets SLI math --------------------------------


def test_window_rates_and_percentiles():
    win = SlidingWindow(bucket_s=1.0, n_buckets=10)
    t0 = 1000.0
    for i in range(90):
        win.observe(10.0, now=t0 + i * 0.01)         # fast bucket
    for i in range(10):
        win.observe(900.0, error=True, deadline_miss=(i < 5),
                    ttft_ms=400.0, now=t0 + i * 0.01)
    s = win.snapshot(5.0, now=t0 + 1.0)
    assert s["count"] == 100 and s["errors"] == 10
    assert s["error_rate"] == pytest.approx(0.10)
    assert s["deadline_miss_rate"] == pytest.approx(0.05)
    # p50 sits in the 10ms bucket, p95/p99 in the 900ms one
    assert s["p50_ms"] <= 25.0
    assert s["p95_ms"] >= 500.0 and s["p99_ms"] >= 500.0
    assert s["ttft_p95_ms"] >= 250.0
    slow, total = win.slow_count(500.0, 5.0, now=t0 + 1.0)
    assert (slow, total) == (10, 100)


def test_window_slides_out_old_buckets():
    win = SlidingWindow(bucket_s=1.0, n_buckets=4)
    win.observe(5.0, error=True, now=100.0)
    assert win.snapshot(2.0, now=100.5)["count"] == 1
    # one horizon later the ring has recycled that bucket
    s = win.snapshot(2.0, now=100.0 + win.horizon_s + 1.0)
    assert s["count"] == 0 and s["error_rate"] == 0.0
    assert win.total == 1                    # lifetime counter unaffected


def test_window_partial_current_bucket_is_included():
    win = SlidingWindow(bucket_s=10.0, n_buckets=6)
    win.observe(1.0, now=205.0)              # mid-bucket
    assert win.snapshot(10.0, now=206.0)["count"] == 1


# --- SLIStore: per-dimension fan-out + bounded keys -------------------------


def test_store_fans_out_to_three_dimensions():
    st = SLIStore(bucket_s=1.0, n_buckets=8)
    st.ingest(plane="generate", client="cam-1", version="m@v3",
              latency_ms=12.0, now=50.0)
    st.ingest(plane="generate", client=None, version=None,
              latency_ms=12.0, error=True, now=50.0)
    assert st.window("plane", "generate").total == 2
    assert st.window("client", "cam-1").total == 1
    assert st.window("client", "_untagged").total == 1
    assert st.window("version", "m@v3").total == 1
    assert st.window("version", "_unversioned").total == 1
    snap = st.snapshot(4.0, now=50.5)
    assert snap["plane"]["generate"]["count"] == 2
    assert snap["client"]["cam-1"]["error_rate"] == 0.0


def test_store_key_space_is_bounded():
    st = SLIStore(bucket_s=1.0, n_buckets=4, max_keys=4)
    for i in range(10):
        st.ingest(plane="generate", client=f"hostile-{i}", version=None,
                  latency_ms=1.0, now=10.0)
    snap = st.snapshot(2.0, now=10.5)
    assert len(snap["client"]) == 5          # 4 real tags + _overflow
    assert snap["client"]["_overflow"]["count"] == 6


# --- UsageLedger: conservation ----------------------------------------------


def test_usage_ledger_conserves_across_rollups():
    """Summing any rollup table (clients, versions) reproduces the
    totals row exactly — attribution neither drops nor double-counts."""
    led = UsageLedger()
    for i in range(60):
        led.ingest(plane="generate" if i % 3 else "infer",
                   client=f"tag-{i % 4}" if i % 5 else None,
                   version=f"m@v{i % 2}",
                   error=(i % 7 == 0),
                   counters={"prefill_tokens": 3 + i,
                             "decode_tokens": 2 * i,
                             "decode_device_ms": 0.25 * i,
                             "decode_host_ms": 0.1 * i,
                             "prefill_ms": 1.5,
                             "decode_transfer_bytes": 64})
    snap = led.snapshot()
    tot = snap["totals"]
    assert tot["requests"] == 60
    assert tot["device_ms"] == pytest.approx(
        tot["decode_device_ms"] + tot["prefill_ms"], rel=1e-6)
    for table in (snap["clients"], snap["versions"]):
        for key in ("requests", "errors", "prefill_tokens",
                    "decode_tokens", "device_ms", "decode_host_ms"):
            assert sum(e[key] for e in table.values()) == \
                pytest.approx(tot[key], rel=1e-6), key
    # the flat /metrics view agrees with the snapshot totals
    flat = led.totals()
    assert flat["requests"] == 60 and flat["clients"] == len(snap["clients"])


def test_usage_ledger_attribution_matches_scheduler_accumulators(engine):
    """Acceptance: per-request cost attribution rolled up by the ledger
    must conserve within 1% of the scheduler's global accumulators."""
    svc = SchedulerService(engine, num_slots=2)
    recorder = FlightRecorder(capacity=64)
    led = UsageLedger()
    try:
        for i in range(4):
            tr = recorder.begin(f"usage-{i}", "generate",
                                client=f"tag-{i % 2}")
            tr.annotate("version", "engine@v1")
            ctx = RequestContext(time.perf_counter(), None, "interactive",
                                 client=tr.client, trace_id=tr.trace_id,
                                 trace=tr)
            out = svc.submit_and_wait(
                [[1, 2, 3 + i]], timeout=30.0, ctx=ctx,
                sampling=SamplingParams(max_new_tokens=4))
            assert len(out.tokens[0]) == 4
            tr.finish(status=200)
            led.ingest(plane="generate", client=tr.client,
                       version="engine@v1", counters=tr.counters)
        stats = svc.stats()["decode"]
        tot = led.snapshot()["totals"]
        assert tot["decode_tokens"] == stats["decode_tokens_total"]
        assert tot["prefill_tokens"] == stats["prefill_tokens_total"]
        for led_key, sched_key in (("decode_device_ms",
                                    "device_ms_total"),
                                   ("decode_host_ms", "host_ms_total")):
            assert tot[led_key] == pytest.approx(
                stats[sched_key], rel=0.01), led_key
        # and the per-version rollup carries the full attribution
        v = led.snapshot()["versions"]["engine@v1"]
        assert v["decode_tokens"] == stats["decode_tokens_total"]
    finally:
        svc.close()


# --- policy loading ---------------------------------------------------------


def test_load_policies_shapes(tmp_path):
    doc = {"policies": [{"name": "p1", "p95_ms": 250.0}]}
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(doc))
    for src in (str(path), doc, doc["policies"]):
        (p,) = load_policies(src)
        assert p.name == "p1" and p.p95_ms == 250.0
        assert p.alias == "canary" and p.promote_to == "stable"
    assert load_policies([SLOPolicy(name="x")])[0].name == "x"
    with pytest.raises(ValueError, match="unknown"):
        load_policies([{"name": "p", "typo_field": 1}])
    with pytest.raises(ValueError, match="name"):
        load_policies([{"alias": "canary"}])
    with pytest.raises(ValueError):
        SLOPolicy(name="bad", success_rate=1.5)
    with pytest.raises(ValueError):
        SLOPolicy(name="bad", fast_window_s=60.0, slow_window_s=30.0)


# --- SLOController: promote / rollback with fake actuators ------------------


def _controller(store, aliases, recorder=None, **policy_kw):
    kw = dict(name="gen", alias="canary", promote_to="stable",
              success_rate=0.9, max_deadline_miss_rate=0.2,
              fast_window_s=4.0, slow_window_s=8.0, burn_threshold=2.0,
              min_requests=5, qualify_window_s=4.0)
    kw.update(policy_kw)
    policy = SLOPolicy(**kw)
    calls = []
    ctl = SLOController(
        store, [policy],
        resolve=lambda alias: aliases.get(alias),
        promote=lambda p: (calls.append("promote"),
                           aliases.__setitem__(p.promote_to,
                                               aliases[p.alias]))[0],
        rollback=lambda p: (calls.append("rollback"),
                            aliases.__setitem__(p.alias,
                                                aliases[p.promote_to]))[0],
        recorder=recorder, cooldown_s=0.0)
    return ctl, calls


def _drive(store, version, n, *, now, error=False, miss=False):
    for i in range(n):
        store.ingest(plane="generate", client="t", version=version,
                     latency_ms=500.0 if (error or miss) else 20.0,
                     error=error, deadline_miss=miss, now=now + i * 0.01)


def test_controller_promotes_healthy_canary():
    store = SLIStore(bucket_s=1.0, n_buckets=16)
    aliases = {"canary": "m@v2", "stable": "m@v1"}
    rec = FlightRecorder(capacity=16)
    ctl, calls = _controller(store, aliases, recorder=rec)
    assert ctl.evaluate(now=100.0) == []     # no traffic yet: observing
    assert ctl.status()["policies"][0]["eval"]["state"] == "no_traffic"
    _drive(store, "m@v2", 8, now=100.0)
    (d,) = ctl.evaluate(now=101.0)
    assert d["action"] == "promote" and d["engine"] == "m@v2"
    assert calls == ["promote"] and aliases["stable"] == "m@v2"
    assert ctl.stats()["promotions"] == 1
    # the decision is auditable as a sealed slo-plane trace
    tr = rec.get(d["trace_id"])
    assert tr is not None and tr.plane == "slo" and tr.status == 200
    # already-stable canary does not re-promote
    _drive(store, "m@v2", 8, now=102.0)
    assert ctl.evaluate(now=103.0) == []


def test_controller_rolls_back_breaching_canary():
    store = SLIStore(bucket_s=1.0, n_buckets=16)
    aliases = {"canary": "m@v2", "stable": "m@v1"}
    ctl, calls = _controller(store, aliases)
    _drive(store, "m@v2", 10, now=100.0, error=True)
    (d,) = ctl.evaluate(now=101.0)
    assert d["action"] == "rollback" and "success_rate" in \
        d["failed_objectives"]
    assert calls == ["rollback"] and aliases["canary"] == "m@v1"
    assert ctl.stats()["rollbacks"] == 1 and ctl.stats()["breaches"] == 1
    # rolled back: canary now points at stable, breach is a no-op
    _drive(store, "m@v1", 10, now=102.0, error=True)
    assert ctl.evaluate(now=103.0) == []


def test_controller_deadline_objective_needs_both_windows():
    """The latency/deadline breach rule is multi-window: misses confined
    to the fast window (slow window still healthy) must NOT flap the
    alias — but sustained misses across both windows must."""
    store = SLIStore(bucket_s=1.0, n_buckets=32)
    aliases = {"canary": "m@v2", "stable": "m@v1"}
    ctl, calls = _controller(store, aliases, success_rate=0.5,
                             fast_window_s=2.0, slow_window_s=16.0)
    # a long healthy history, then a 1-bucket spike of misses
    _drive(store, "m@v2", 40, now=100.0)
    _drive(store, "m@v2", 6, now=112.0, miss=True)
    assert ctl.evaluate(now=112.5) == []
    assert calls != ["rollback"]
    # sustained misses: both windows now fail deadline_miss_rate
    _drive(store, "m@v2", 30, now=113.0, miss=True)
    (d,) = ctl.evaluate(now=114.0)
    assert d["action"] == "rollback"
    assert "deadline_miss_rate" in d["failed_objectives"]


def test_controller_cooldown_and_no_target():
    store = SLIStore(bucket_s=1.0, n_buckets=16)
    aliases = {"stable": "m@v1"}             # canary alias dangling
    ctl, calls = _controller(store, aliases)
    ctl._cooldowns["gen"] = 300.0
    assert ctl.evaluate(now=100.0) == []
    assert ctl.status()["policies"][0]["eval"]["state"] == "no_target"
    aliases["canary"] = "m@v2"
    _drive(store, "m@v2", 8, now=100.0)
    (d,) = ctl.evaluate(now=101.0)           # first decision allowed
    assert d["action"] == "promote"
    aliases["canary"] = "m@v3"               # new canary right away
    _drive(store, "m@v3", 8, now=102.0)
    assert ctl.evaluate(now=103.0) == []     # in cooldown: held
    assert calls == ["promote"]


# --- HTTP surfaces + end-to-end autopilot -----------------------------------


class _LaggyEngine:
    """Delegating engine proxy whose decode ticks sleep: latency fault
    injection for the rollback half of the drill."""

    def __init__(self, inner, tick_delay_s):
        self._inner = inner
        self._tick_delay_s = tick_delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def decode_sample(self, *a, **kw):
        time.sleep(self._tick_delay_s)
        return self._inner.decode_sample(*a, **kw)

    def decode(self, *a, **kw):
        time.sleep(self._tick_delay_s)
        return self._inner.decode(*a, **kw)


def test_autopilot_end_to_end(engine):
    """Healthy canary auto-promoted; fault-injected canary auto-rolled
    back; zero failed requests on stable; decisions retrievable from
    GET /v1/slo and the flight recorder; usage attributed per version.

    Each round of traffic is a burst of concurrent requests, one client
    each: a burst shares its decode ticks, so its requests finish together
    and land in one SLI window however long an eager tick takes on a
    loaded machine (sent one at a time, ``min_requests`` of them no longer
    fit in the 1.5 s qualifying window once a tick passes about 50 ms)."""
    policy = SLOPolicy(name="gen-canary", alias="canary",
                       promote_to="stable", plane="generate",
                       success_rate=0.90, max_deadline_miss_rate=0.2,
                       fast_window_s=1.0, slow_window_s=2.0,
                       burn_threshold=2.0, min_requests=6,
                       qualify_window_s=1.5)
    burst = policy.min_requests + 2        # one wave of the plane's slots
    app = FlexServeApp(ModelRegistry(), None, engine, num_slots=burst,
                       slo_policies=[policy], slo_interval_s=0.2,
                       sli_bucket_s=0.25, sli_n_buckets=64)
    srv = FlexServeServer(app).start()
    cl = FlexServeClient(*srv.address, retries=0)
    stable_failures = []

    def one(target, i, deadline_ms, tokens):
        c = FlexServeClient(*srv.address, retries=0)
        try:
            c.generate([[1, 2, 3 + i % 5]], max_new_tokens=tokens,
                       target=target, deadline_ms=deadline_ms,
                       client_tag=f"tenant-{target}")
        except HTTPStatusError:
            if target == "stable":
                stable_failures.append(target)
        finally:
            c.close()

    def drive(target, n, deadline_ms=None, tokens=4):
        """``n`` requests at once; returns when all have answered."""
        threads = [threading.Thread(target=one,
                                    args=(target, i, deadline_ms, tokens))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def wait_for(pred, what, timeout_s=30.0):
        t0 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t0 > timeout_s:
                pytest.fail(f"autopilot never reached: {what}")
            time.sleep(0.05)

    try:
        # phase 1: a healthy canary qualifies and is promoted
        app.generation.install("engine", 1, engine, alias="canary",
                               warm=True)
        wait_for(lambda: (drive("canary", burst) or drive("stable", 2)
                          or app.slo.stats()["promotions"] >= 1),
                 "healthy canary promotion")
        assert app._slo_resolve("stable") == "engine@v1"
        # phase 2: a laggy canary blows the deadline SLO and rolls back
        app.generation.install("engine", 2, _LaggyEngine(engine, 0.08),
                               alias="canary", warm=False)
        wait_for(lambda: (drive("canary", burst, deadline_ms=200,
                                tokens=8)
                          or drive("stable", 2)
                          or app.slo.stats()["rollbacks"] >= 1),
                 "faulty canary rollback")
        assert app._slo_resolve("canary") == "engine@v1"
        assert stable_failures == []
        # decision audit: /v1/slo, stats, and the flight recorder agree
        status = cl.slo()
        actions = [d["action"] for d in status["decisions"]]
        assert "promote" in actions and "rollback" in actions
        last = status["decisions"][-1]
        tr = cl.trace(last["trace_id"])
        assert tr["plane"] == "slo" and tr["status"] == 200
        assert status["promotions"] >= 1 and status["rollbacks"] >= 1
        # usage: both versions billed, canary tenant saw the canary
        usage = cl.usage()
        assert usage["versions"]["engine@v1"]["decode_tokens"] > 0
        assert usage["versions"]["engine@v2"]["requests"] > 0
        assert cl.usage(client="tenant-canary")["clients"].keys() == \
            {"tenant-canary"}
        # /v1/traces filters: only 5xx/504 rows, only the canary tenant
        rows = cl.traces(status=504, client="tenant-canary",
                         limit=50)["recent"]
        assert rows and all(r["status"] == 504 for r in rows)
        assert all(r["client"] == "tenant-canary" for r in rows)
        slow = cl.traces(min_duration_ms=150.0, limit=50)["recent"]
        assert all(r["duration_ms"] >= 150.0 for r in slow)
        with pytest.raises(HTTPStatusError, match="400"):
            cl.traces(status="not-an-int")
    finally:
        cl.close()
        srv.stop()


# --- the pure functions against the JAX package ---------------------------


def _observations(seed, n=300):
    """Synthetic (latency, error, miss, ttft, t) rows from a numpy
    generator: mixed fast/slow latencies over a few buckets."""
    rng = np.random.default_rng(seed)
    lat = np.where(rng.random(n) < 0.8, rng.uniform(1, 40, n),
                   rng.uniform(200, 5000, n))
    return [(float(lat[i]), bool(rng.random() < 0.1),
             bool(rng.random() < 0.05),
             float(rng.uniform(5, 900)) if rng.random() < 0.5 else None,
             1000.0 + float(rng.uniform(0, 12))) for i in range(n)]


@pytest.mark.parametrize("seed,bucket_s,n_buckets,window_s",
                         [(0, 1.0, 10, 5.0), (1, 0.25, 64, 3.0),
                          (2, 2.0, 4, 8.0)])
def test_window_snapshots_equal_the_jax_package(seed, bucket_s, n_buckets,
                                                window_s):
    wins = [mod.SlidingWindow(bucket_s=bucket_s, n_buckets=n_buckets)
            for mod in (jslo, tslo)]
    for lat, err, miss, ttft, t in _observations(seed):
        for w in wins:
            w.observe(lat, error=err, deadline_miss=miss, ttft_ms=ttft,
                      now=t)
    for now in (1005.0, 1012.5, 1020.0):
        want = wins[0].snapshot(window_s, now=now)
        assert wins[1].snapshot(window_s, now=now) == want
        assert wins[1].slow_count(250.0, window_s, now=now) == \
            wins[0].slow_count(250.0, window_s, now=now)
    assert wins[1].total == wins[0].total


def test_store_and_ledger_equal_the_jax_package():
    stores = [mod.SLIStore(bucket_s=1.0, n_buckets=16, max_keys=6)
              for mod in (jslo, tslo)]
    ledgers = [jslo.UsageLedger(), tslo.UsageLedger()]
    for i, (lat, err, miss, ttft, t) in enumerate(_observations(3)):
        kw = dict(plane="generate" if i % 3 else "infer",
                  client=f"tag-{i % 9}" if i % 5 else None,
                  version=f"m@v{i % 3}")
        counters = {"prefill_tokens": 3 + i, "decode_tokens": 2 * i,
                    "decode_device_ms": 0.25 * i, "decode_host_ms": 0.1 * i,
                    "prefill_ms": 1.5, "decode_transfer_bytes": 64}
        for st in stores:
            st.ingest(latency_ms=lat, error=err, deadline_miss=miss,
                      ttft_ms=ttft, now=t, **kw)
        for led in ledgers:
            led.ingest(error=err, counters=counters, **kw)
    assert stores[1].snapshot(6.0, now=1012.0) == \
        stores[0].snapshot(6.0, now=1012.0)
    assert ledgers[1].snapshot() == ledgers[0].snapshot()
    assert ledgers[1].totals() == ledgers[0].totals()
    assert ledgers[1].snapshot(client="tag-1") == \
        ledgers[0].snapshot(client="tag-1")


def _transcript(mod, recorder_cls, scenario):
    """Run one controller scenario on a package's SLO module; returns its
    decisions (without the wall-clock stamp), stats and final status."""
    store = mod.SLIStore(bucket_s=1.0, n_buckets=32)
    aliases = {"canary": "m@v2", "stable": "m@v1"}
    policy = mod.SLOPolicy(
        name="gen", alias="canary", promote_to="stable", success_rate=0.9,
        max_deadline_miss_rate=0.2, p95_ms=scenario.get("p95_ms"),
        fast_window_s=4.0, slow_window_s=8.0, burn_threshold=2.0,
        min_requests=5, qualify_window_s=4.0)
    ctl = mod.SLOController(
        store, [policy], resolve=aliases.get,
        promote=lambda p: aliases.__setitem__(p.promote_to,
                                              aliases[p.alias]),
        rollback=lambda p: aliases.__setitem__(p.alias,
                                               aliases[p.promote_to]),
        recorder=recorder_cls(capacity=8), cooldown_s=0.0)
    out = []
    for step, (version, n, kind) in enumerate(scenario["steps"]):
        now = 100.0 + 2.0 * step
        for i in range(n):
            store.ingest(plane="generate", client="t", version=version,
                         latency_ms=600.0 if kind else 20.0,
                         error=kind == "error", deadline_miss=kind == "miss",
                         now=now + i * 0.01)
        for d in ctl.evaluate(now=now + 1.0):
            out.append({k: v for k, v in d.items() if k != "unix_time"})
    status = ctl.status(window_s=8.0)
    return out, ctl.stats(), status["policies"], dict(aliases)


# each scenario with the actions it must take (the healthy history of
# "misses" qualifies the canary before the misses arrive)
SCENARIOS = {
    "healthy": {"steps": [("m@v2", 8, None), ("m@v2", 8, None)],
                "actions": ["promote"]},
    "errors": {"steps": [("m@v2", 10, "error"), ("m@v1", 10, "error")],
               "actions": ["rollback"]},
    "misses": {"steps": [("m@v2", 40, None), ("m@v2", 6, "miss"),
                         ("m@v2", 30, "miss"), ("m@v1", 5, None)],
               "actions": ["promote"]},
    "latency": {"p95_ms": 100.0,
                "steps": [("m@v2", 3, None), ("m@v2", 12, "slow"),
                          ("m@v2", 12, "slow")],
                "actions": ["rollback"]},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decisions_equal_the_jax_package(name):
    want = _transcript(jslo, JRecorder, SCENARIOS[name])
    got = _transcript(tslo, FlightRecorder, SCENARIOS[name])
    assert got == want
    assert [d["action"] for d in got[0]] == SCENARIOS[name]["actions"]

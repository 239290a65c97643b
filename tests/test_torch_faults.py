"""The port's fault injector (``repro_torch/core/faults.py``), a copy of
the JAX package's: the cases of tests/test_faults.py run on the port's
copy, and both injectors fed the same schedules and hit sequences decide
the same hits."""

import json
import time

import numpy as np
import pytest

from repro.core.faults import FaultInjector as JFaultInjector
from repro.core.faults import ZERO_FAULT_STATS as J_ZERO_FAULT_STATS
from repro_torch.core.faults import (ZERO_FAULT_STATS, FaultInjector,
                                     FaultSpec, InjectedFault)


def test_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec(site="x", action="explode")
    with pytest.raises(ValueError):
        FaultSpec(site="x", at=0)
    with pytest.raises(ValueError):
        FaultSpec(site="x", every=0)
    with pytest.raises(ValueError):
        FaultInjector.from_config([{"site": "x", "frequency": 2}])


def test_at_every_count_schedule():
    inj = FaultInjector.from_config(
        [{"site": "s", "at": 3, "every": 2, "count": 2}])
    fired = [hit for hit in range(1, 11)
             if inj.should("s") is not None]
    assert fired == [3, 5]


def test_unlimited_count():
    inj = FaultInjector.from_config([{"site": "s", "at": 1, "count": 0}])
    assert sum(inj.should("s") is not None for _ in range(7)) == 7


def test_fire_raises_with_site_and_message():
    inj = FaultInjector.from_config(
        {"faults": [{"site": "boom", "message": "injected oom"}]})
    with pytest.raises(InjectedFault) as ei:
        inj.fire("boom")
    assert ei.value.site == "boom"
    assert "injected oom" in str(ei.value)
    assert isinstance(ei.value, RuntimeError)
    assert inj.fire("boom") is None


def test_stall_sleeps_and_returns_action():
    inj = FaultInjector.from_config(
        [{"site": "tick", "action": "stall", "delay_ms": 60}])
    t0 = time.monotonic()
    assert inj.fire("tick") == "stall"
    assert time.monotonic() - t0 >= 0.05
    assert inj.fire("tick") is None


def test_per_replica_counters_are_independent():
    inj = FaultInjector.from_config([{"site": "s", "at": 2, "count": 1}])
    assert inj.should("s", replica=0) is None
    assert inj.should("s", replica=1) is None
    assert inj.should("s", replica=0) is not None
    assert inj.should("s", replica=1) is not None
    assert inj.should("s", replica=0) is None


def test_replica_scoped_spec_only_matches_its_replica():
    inj = FaultInjector.from_config(
        [{"site": "s", "replica": 1, "at": 1}])
    assert inj.should("s", replica=0) is None
    assert inj.should("s", replica=2) is None
    assert inj.should("s", replica=1) is not None
    scoped = inj.scoped(1)
    assert scoped.should("s") is None


def test_load_coercions(tmp_path):
    assert FaultInjector.load(None) is None
    inj = FaultInjector([FaultSpec(site="s")])
    assert FaultInjector.load(inj) is inj
    assert FaultInjector.load([{"site": "s"}]).should("s") is not None
    p = tmp_path / "faults.json"
    p.write_text(json.dumps({"faults": [{"site": "s", "at": 1}]}))
    assert FaultInjector.load(str(p)).should("s") is not None


def test_stats_accounting():
    inj = FaultInjector.from_config(
        [{"site": "a", "count": 1}, {"site": "b", "count": 2, "at": 1}])
    assert inj.should("b") is not None
    with pytest.raises(InjectedFault):
        inj.fire("a")
    assert inj.should("b") is not None
    s = inj.stats()
    assert s["enabled"] and s["specs"] == 2 and s["fired_total"] == 3
    assert s["sites"]["a"] == {"specs": 1, "hits": 1, "fired": 1}
    assert s["sites"]["b"] == {"specs": 1, "hits": 2, "fired": 2}
    assert set(ZERO_FAULT_STATS) == set(s)
    assert dict(ZERO_FAULT_STATS) == dict(J_ZERO_FAULT_STATS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_and_stats_equal_the_jax_injector(seed):
    """A random schedule (sites, at/every/count, replica-scoped and not)
    and a random sequence of hits: both injectors mark the same hits due,
    with the same spec, and end with equal stats."""
    r = np.random.default_rng(seed)
    sites = ["engine_step", "prefill", "replica_kill"]
    cfg = [{"site": sites[int(r.integers(3))], "at": int(r.integers(1, 5)),
            "every": int(r.integers(1, 4)), "count": int(r.integers(0, 4)),
            "replica": (None if r.random() < 0.5
                        else int(r.integers(0, 3)))}
           for _ in range(5)]
    ours, theirs = FaultInjector.load(cfg), JFaultInjector.load(cfg)
    for _ in range(200):
        site = sites[int(r.integers(3))]
        rid = None if r.random() < 0.2 else int(r.integers(0, 3))
        a, b = ours.should(site, rid), theirs.should(site, rid)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.site, a.at, a.every, a.count, a.replica) == \
                (b.site, b.at, b.every, b.count, b.replica)
    assert ours.stats() == theirs.stats()

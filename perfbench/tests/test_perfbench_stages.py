"""The readers of the program's stage recorder and counters: their
arithmetic on synthetic ``/metrics`` pairs, nothing where there is
nothing to read (a program without the recorder, or with tracing off),
and their files against ``BENCHMARK.json``."""

import copy
from types import SimpleNamespace

import pytest

from perfbench.harness import spec, stages

READERS = {
    "idle_between_forwards.bulk": "idle_between_forwards_pct",
    "idle_between_forwards.interactive": "idle_between_forwards_pct",
    "dispatch_stall_ms.bulk": "dispatch_stall_ms",
    "dispatch_stall_ms.interactive": "dispatch_stall_ms",
    "batcher_padded_rows": "batcher_padded_rows_pct",
    "frontend_ms.bulk": "frontend_ms",
    "frontend_ms.interactive": "frontend_ms",
}


def hist(count, total):
    return {"le": [1.0, "+Inf"], "counts": [0, count], "count": count,
            "sum": total}


def doc(forwards, fwd_ms, gap_ms, stage_ms, rows, padded):
    """A /metrics document as far as the readers look; ``stage_ms`` maps
    a stage to (count, wall ms, cpu ms)."""
    return {
        "coalesce": {"batches_formed": forwards,
                     "device_forward_ms_hist": hist(forwards, fwd_ms),
                     "device_gap_ms_hist": hist(max(forwards - 1, 0),
                                                gap_ms)},
        "stages": {s: {"wall_ms_hist": hist(n, w), "cpu_ms": c}
                   for s, (n, w, c) in stage_ms.items()},
        "ensemble_batches": {"forwards": forwards, "rows_total": rows,
                             "padded_rows_total": padded}}


BEFORE = doc(10, 6000.0, 50.0,
             {"coalesce.launch": (10, 300.0, 250.0),
              "coalesce.collect": (30, 20.0, 10.0),
              "coalesce.merge": (10, 15.0, 5.0),
              "coalesce.scatter": (10, 40.0, 30.0),
              "frontend.parse": (12, 60.0, 50.0),
              "frontend.respond": (12, 24.0, 20.0)},
             rows=100, padded=12)
AFTER = doc(14, 8400.0, 74.0,
            {"coalesce.launch": (14, 420.0, 350.0),
             "coalesce.collect": (44, 32.0, 14.0),
             "coalesce.merge": (14, 25.0, 9.0),
             "coalesce.scatter": (14, 56.0, 38.0),
             "frontend.parse": (20, 140.0, 90.0),
             "frontend.respond": (20, 56.0, 40.0)},
            rows=154, padded=22)


def run(before=BEFORE, after=AFTER):
    return SimpleNamespace(stats_before=copy.deepcopy(before),
                           stats_after=copy.deepcopy(after))


def metric(name):
    return spec.metric_module(name).read


@pytest.mark.parametrize("name", ["idle_between_forwards.bulk",
                                  "idle_between_forwards.interactive"])
def test_idle_between_forwards(name):
    # 24 ms of gaps against 2400 ms of forwards
    assert metric(name)(run()) == pytest.approx(100 * 24 / (24 + 2400))


@pytest.mark.parametrize("name", ["dispatch_stall_ms.bulk",
                                  "dispatch_stall_ms.interactive"])
def test_dispatch_stall(name):
    # (12 - 4) + (10 - 4) + (16 - 8) ms over 4 forwards
    assert metric(name)(run()) == pytest.approx((8 + 6 + 8) / 4)


def test_batcher_padded_rows():
    assert metric("batcher_padded_rows")(run()) == pytest.approx(
        100 * 10 / (54 + 10))


@pytest.mark.parametrize("name", ["frontend_ms.bulk",
                                  "frontend_ms.interactive"])
def test_frontend_ms(name):
    assert metric(name)(run()) == pytest.approx(80 / 8 + 32 / 8)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_gives_nothing(name):
    read = metric(name)
    # the parent program: no stages, device marks or batcher counters
    bare = {"coalesce": {"batches_formed": 10}}
    assert read(run(bare, {"coalesce": {"batches_formed": 14}})) is None
    # a window in which nothing was recorded (tracing off, or no forward)
    still = run(AFTER, AFTER)
    assert read(still) is None
    # a section missing on one side only
    half = copy.deepcopy(AFTER)
    for k in ("stages", "ensemble_batches"):
        half.pop(k)
    half["coalesce"].pop("device_gap_ms_hist")
    assert read(run(BEFORE, half)) is None


def test_the_readers_are_the_harness_functions():
    for name, fn in READERS.items():
        mod = spec.metric_module(name)
        assert mod.read(run()) == getattr(stages, fn)(run()), name


def test_the_metric_files_agree_with_benchmark_json():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    closed = ["yi9b-pair.bulk", "danube-pair.long"]
    for name in READERS:
        m = entries[name]
        mod = spec.metric_module(name)
        assert (mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"])
        assert m["better"] == "lower"
        want = (closed if name.endswith(".bulk")
                else ["yi9b-pair.interactive"])
        assert m["workloads"] == want
        assert m["moves"] == ("infer_rows_per_s" if name.endswith(".bulk")
                              else "overload_rows_per_s")
    # appended after every entry the benchmark had
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(READERS):] == list(READERS)

"""The check that decides ``correct``, driven through a whole run of the
harness on the CPU at a tiny size (the look for a card skipped): sound
runs pass, and each fault a serving cell can have, planted in the timed
path, makes ``correct`` false.  The control (the reference in float8)
fails the cells' limits."""

import time

import numpy as np
import pytest
import torch

from perfbench.harness import bench, check, spec
from perfbench.harness import weights as wmod
from perfbench.reference import dense_gqa
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_run(traffic=tiny.CLOSED, trace=False, seconds=1.5, seed=2**32 + 3):
    out, lines, run = bench.run(tiny.cell(traffic), seed, seconds, trace,
                                "cpu", time.perf_counter(), log=lambda m: None)
    return out, lines, run


@pytest.mark.parametrize("traffic,trace", [(tiny.CLOSED, False),
                                           (tiny.OPEN, False),
                                           (tiny.CLOSED, True)])
def test_a_sound_run_is_correct(traffic, trace):
    out, lines, run = tiny_run(traffic, trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 5 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {k: v["limit"] for k, v in out["checks"].items()} == {
        "wrong_answers": 0, "never_answered": 0,
        "logit_err": tiny.TINY_CONFIG["check"]["limits"]["logit_err"]}
    assert len(lines) == 3 and all(" limit " in line for line in lines)
    names = {m["name"] for m in tiny.cell(traffic).metrics(trace)}
    assert set(out["metrics"]) == names
    assert all(np.isfinite(v["value"]) and v["value"] >= 0
               for v in out["metrics"].values())
    if not trace:        # the end-to-end metrics are never 0
        assert all(v["value"] > 0 for v in out["metrics"].values())
    if trace:
        assert "busy_s" in out["device"] and "breakdown" in out


def test_answers_and_logits_follow_the_rows(monkeypatch):
    """Coalesced requests get their own rows' answers back: the open
    loop's requests share forwards."""
    out, _, run = tiny_run(tiny.OPEN)
    assert out["correct"] and out["checks"]["wrong_answers"]["value"] == 0
    assert out["metrics"]["infer_rows_per_s"]["value"] > 0


def planted(monkeypatch, fault):
    from repro_torch.core import ensemble as ens_mod
    from repro_torch.models import transformer
    from repro_torch.serving import api
    if fault == "answer_altered":
        orig = ens_mod.Ensemble._format_response

        def altered(self, out, policy):
            resp = orig(self, out, policy)
            resp["ensemble"][0] = "class_%d" % (
                (int(resp["ensemble"][0].split("_")[1]) + 1) % 16)
            return resp
        monkeypatch.setattr(ens_mod.Ensemble, "_format_response", altered)
    elif fault == "token_altered":
        orig = api.inputs_to_batch

        def altered(inputs):
            batch = orig(inputs)
            batch["tokens"] = batch["tokens"].copy()
            batch["tokens"][:, 0] = (batch["tokens"][:, 0] + 1) % 512
            return batch
        monkeypatch.setattr(api, "inputs_to_batch", altered)
    elif fault == "half_the_batch":
        orig = transformer.forward

        def half(params, tokens, cfg, **kw):
            n = max(1, tokens.shape[0] // 2)
            out = orig(params, tokens[:n], cfg, **kw)
            rest = out.mean(0, keepdim=True).expand(
                tokens.shape[0] - n, *out.shape[1:])
            return torch.cat([out, rest])
        monkeypatch.setattr(transformer, "forward", half)
    elif fault == "stale_output":
        orig = transformer.forward
        last = {}

        def stale(params, tokens, cfg, **kw):
            out = orig(params, tokens, cfg, **kw)
            prev = last.get(tokens.shape)
            last[tokens.shape] = out
            return out if prev is None else prev
        monkeypatch.setattr(transformer, "forward", stale)
    elif fault == "forward_raises":
        def broken(params, tokens, cfg, **kw):
            raise RuntimeError("planted")
        monkeypatch.setattr(transformer, "forward", broken)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault,fails", [
    ("answer_altered", "wrong_answers"),
    ("token_altered", "logit_err"),
    ("half_the_batch", "logit_err"),
    ("stale_output", "logit_err"),
])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, fails):
    planted(monkeypatch, fault)
    out, _, _ = tiny_run(tiny.CLOSED)
    assert out["correct"] is False
    c = out["checks"][fails]
    assert c["value"] > c["limit"], out["checks"]


def test_a_fault_that_starts_after_the_first_forward_is_not_correct(
        monkeypatch):
    """Each member's forward returns its previous output of that shape
    (a buffer reused, a cache gone stale), but only once the window's
    first forward has run: its answers agree with the logits the program
    recorded, and only rows drawn from across the window see it."""
    from repro_torch.models import transformer
    orig_warm, orig_fwd = bench.warm_up, transformer.forward

    def warm_then_plant(*a, **kw):
        orig_warm(*a, **kw)
        calls, last = [0], {}
        members = len(tiny.TINY_CONFIG["members"])

        def late_stale(params, tokens, cfg, **kw):
            out = orig_fwd(params, tokens, cfg, **kw)
            calls[0] += 1
            key = (id(params), tuple(tokens.shape))
            prev, last[key] = last.get(key), out
            return out if calls[0] <= members or prev is None else prev
        monkeypatch.setattr(transformer, "forward", late_stale)
    monkeypatch.setattr(bench, "warm_up", warm_then_plant)
    out, _, _ = tiny_run(tiny.CLOSED)
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] == 0
    c = out["checks"]["logit_err"]
    assert c["value"] > c["limit"], out["checks"]


def fake_results(n_req, rows, seq, t_start=100.0, seconds=30.0):
    from perfbench.harness import load
    from perfbench.harness.traffic import Request
    out = []
    for k in range(n_req):
        due = t_start + seconds * k / n_req
        tok = np.full((rows, seq), k, np.int32)
        tok[:, 1] = np.arange(rows)
        out.append(load.Result(Request(k, 0, rows, seq), tok, due, due,
                               due + 1.0, 200, b"{}"))
    return out


@pytest.mark.parametrize("n_req,rows,n", [(40, 16, 16), (30, 4, 4),
                                          (3, 4, 6)])
def test_sampled_rows_span_the_window(n_req, rows, n):
    """One row of each of ``n`` requests where the window answered that
    many, one of them due in its last third; drawn from the seed."""
    res = fake_results(n_req, rows, 8)
    t_late = 100.0 + 20.0
    picked = bench.sample_rows(res, n, 2**33 + 5, t_late)
    assert len(picked) == n
    reqs = [int(r[0]) for r in picked]
    assert len({tuple(r) for r in picked}) == n
    if n_req >= n:
        assert len(set(reqs)) == n
    assert any(res[k].due >= t_late for k in reqs)
    again = bench.sample_rows(res, n, 2**33 + 5, t_late)
    assert all((a == b).all() for a, b in zip(picked, again))
    other = bench.sample_rows(res, n, 2**33 + 6, t_late)
    assert [tuple(r) for r in other] != [tuple(r) for r in picked]


def test_sampled_rows_hold_the_longest_request():
    res = fake_results(20, 2, 8)
    longest = fake_results(1, 2, 24)[0]
    res.insert(7, longest)
    picked = bench.sample_rows(res, 4, 11, 100.0 + 20.0)
    assert max(len(r) for r in picked) == 24


@pytest.mark.parametrize("cell", ["yi9b-pair.bulk", "danube-pair.long"])
def test_the_control_fails_the_cells_limit(cell):
    """The reference in float8 in the program's place, at a size a test
    run holds (2 layers of the cell's kind and GQA ratio, bfloat16 weights, 64
    tokens):
    its logits part from the float32 reference's by more than the cell's
    limit.  On the card, ``control.py`` reads it at the cell's own size."""
    cfg = spec.load_cell(cell).config
    arch = dict(cfg["arch"], num_layers=2, d_model=256, d_ff=512,
                vocab_size=512, num_heads=8,
                num_kv_heads=8 // (cfg["arch"]["num_heads"]
                                   // cfg["arch"]["num_kv_heads"]),
                head_dim=32)
    arch["sliding_window"] = 40 if arch["sliding_window"] else None
    tok = torch.randint(0, 512, (4, 64),
                        generator=torch.Generator().manual_seed(5))
    low, exact = [], []
    for m in range(2):
        w = wmod.make(wmod.dense_gqa_layout(arch), 7, m, "cpu")
        exact.append(dense_gqa.class_logits(w, tok, arch, 16).numpy())
        low.append(dense_gqa.class_logits(w, tok, arch, 16,
                                          precision="fp8").numpy())
    err = check.logit_err(low, exact)
    assert err > cfg["check"]["limits"]["logit_err"], err


def test_a_run_with_no_answer_is_not_correct(monkeypatch):
    """Warm-up goes through the route, so a forward that always fails
    stops the run before its window; after warm-up, failing requests
    count as failed and the run is not correct."""
    with pytest.raises(RuntimeError):
        planted(monkeypatch, "forward_raises")
        tiny_run(tiny.CLOSED)
    monkeypatch.undo()
    from perfbench.harness import bench as bench_mod
    orig = bench_mod.warm_up

    def warm_then_break(*a, **kw):
        orig(*a, **kw)
        planted(monkeypatch, "forward_raises")
    monkeypatch.setattr(bench_mod, "warm_up", warm_then_break)
    out, _, _ = tiny_run(tiny.CLOSED)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] > 0
    assert out["checks"]["logit_err"]["value"] == check.MISSING


def test_logit_err():
    r = [np.array([[1.0, -1.0], [2.0, 0.0]])]
    p = [np.array([[1.1, -1.0], [2.0, 0.0]])]
    assert check.logit_err(p, r) == pytest.approx(0.1 / np.sqrt(1.5))
    assert check.logit_err([p[0][:1]], r) == check.MISSING
    assert check.logit_err([np.full((2, 2), np.nan)], r) == check.MISSING

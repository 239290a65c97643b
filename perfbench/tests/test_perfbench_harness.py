"""The harness's parts on the CPU: the reference against float64, the
traffic generator, the open loop's timing, the metrics' arithmetic, the
trace's reduction, finding parts by name, and what the benchmark may
import."""

import ast
import http.server
import json
import math
import shutil
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.harness import load, readers, spec
from perfbench.harness import weights as wmod
from perfbench.harness.profile import Profile, reduce_trace, short_name
from perfbench.harness.traffic import Mix
from perfbench.reference import dense_gqa

ROOT = spec.ROOT
PERFBENCH = spec.PERFBENCH


# --- the plain reference -----------------------------------------------------


def naive64(w, tokens, arch, C):
    """Token by token, head by head, in float64: an independent
    computation of the same model."""
    W = {k: v.double() for k, v in w.items()}
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    eps, window = arch["norm_eps"], arch["sliding_window"]
    R, S = tokens.shape
    inv = 1.0 / (arch["rope_theta"] ** (np.arange(0, hd, 2) / hd))

    def norm(x, s):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * s

    def rot(v, pos):
        a = torch.tensor(pos * inv, dtype=torch.float64)
        x1, x2 = v[..., :hd // 2], v[..., hd // 2:]
        return torch.cat([x1 * torch.cos(a) - x2 * torch.sin(a),
                          x1 * torch.sin(a) + x2 * torch.cos(a)], -1)

    out = []
    for r in range(R):
        x = W["embed"][tokens[r].long()]
        for i in range(arch["num_layers"]):
            p = {k[7:]: v[i] for k, v in W.items() if k.startswith("layers/")}
            h = norm(x, p["ln1/scale"])
            q = (h @ p["attn/wq"]).view(S, H, hd)
            k = (h @ p["attn/wk"]).view(S, K, hd)
            v = (h @ p["attn/wv"]).view(S, K, hd)
            q = torch.stack([rot(q[t], t) for t in range(S)])
            k = torch.stack([rot(k[t], t) for t in range(S)])
            att = torch.zeros(S, H, hd, dtype=torch.float64)
            for t in range(S):
                for hh in range(H):
                    kv = hh // (H // K)
                    keys = [j for j in range(t + 1)
                            if window is None or j > t - window]
                    sc = torch.stack([q[t, hh] @ k[j, kv] for j in keys])
                    pr = torch.softmax(sc / math.sqrt(hd), 0)
                    att[t, hh] = sum(pr[n] * v[j, kv]
                                     for n, j in enumerate(keys))
            x = x + att.reshape(S, H * hd) @ p["attn/wo"]
            h = norm(x, p["ln2/scale"])
            g = torch.nn.functional.silu(h @ p["mlp/w_gate"])
            x = x + (g * (h @ p["mlp/w_up"])) @ p["mlp/w_down"]
        last = norm(x[-1], W["final_norm/scale"])
        out.append(last @ W["head"][:, :C])
    return torch.stack(out)


@pytest.mark.parametrize("window", [None, 5])
def test_reference_against_float64(window):
    arch = {"num_layers": 2, "d_model": 32, "num_heads": 4,
            "num_kv_heads": 2, "head_dim": 8, "d_ff": 48,
            "vocab_size": 50, "sliding_window": window,
            "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32"}
    w = wmod.make(wmod.dense_gqa_layout(arch), 3, 0, "cpu")
    tokens = torch.randint(0, 50, (2, 12), generator=torch.Generator()
                           .manual_seed(0))
    got = dense_gqa.class_logits(w, tokens, arch, 6).double()
    want = naive64(w, tokens, arch, 6)
    assert got.shape == (2, 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    low = dense_gqa.class_logits(w, tokens, arch, 6, precision="fp8")
    assert (low.double() - want).abs().max() > 1e-3


def test_attention_blocks_agree():
    """A block of queries smaller than S gives the one-block result."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 40, 4, 8, generator=g) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    whole = dense_gqa.attention(q, k, v, 9)
    old = dense_gqa.SCORE_BYTES
    try:
        dense_gqa.SCORE_BYTES = 4 * 2 * 4 * 40 * 16
        blocked = dense_gqa.attention(q, k, v, 9)
    finally:
        dense_gqa.SCORE_BYTES = old
    torch.testing.assert_close(blocked, whole)


# --- traffic -----------------------------------------------------------------


INTERACTIVE = spec.load_traffic("interactive")


def test_seeded_traffic_repeats_exactly():
    a, b = Mix(INTERACTIVE, 2**33 + 5, 64000), Mix(INTERACTIVE, 2**33 + 5,
                                                   64000)
    assert a.schedule(30.0) == b.schedule(30.0)
    r = a.schedule(30.0)[7]
    np.testing.assert_array_equal(a.tokens(r), b.tokens(r))
    c = Mix(spec.load_traffic("bulk"), 9, 64000)
    assert c.closed_request(1, 130) == Mix(c.spec, 9, 64000) \
        .closed_request(1, 130)


def test_every_seed_gets_the_same_work():
    s1 = Mix(INTERACTIVE, 1, 64000).schedule(30.0)
    s2 = Mix(INTERACTIVE, 2, 64000).schedule(30.0)
    assert len(s1) == len(s2) == round(INTERACTIVE["rate_per_s"] * 30)
    assert sorted(r.rows for r in s1) == sorted(r.rows for r in s2)
    assert [r.rows for r in s1] != [r.rows for r in s2]
    rows = [r.rows for r in s1]
    for n, share in INTERACTIVE["rows"]:
        assert abs(rows.count(n) - len(rows) * share / 100) <= 1
    for s in (s1, s2):
        assert s[0].due_s == 0.0 and s[-1].due_s < 30.0
        assert all(x.due_s < y.due_s for x, y in zip(s, s[1:]))
    gaps = sorted(np.diff([r.due_s for r in s1] + [30.0]))
    np.testing.assert_allclose(
        gaps, sorted(np.diff([r.due_s for r in s2] + [30.0])))


def test_tokens_are_uniform_ids_of_the_request_size():
    mix = Mix(spec.load_traffic("long"), 2**31 + 11, 32000)
    req = mix.closed_request(0, 0)
    t = mix.tokens(req)
    assert t.shape == (4, 8192) and t.dtype == np.int32
    assert 0 <= t.min() and t.max() < 32000


# --- the open loop times from the due time -----------------------------------


class StallOnce(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    calls = 0
    lock = threading.Lock()

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with StallOnce.lock:
            StallOnce.calls += 1
            n = StallOnce.calls
        time.sleep(0.6 if n == 3 else 0.005)
        body = b"{}"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_open_loop_counts_a_stall_in_later_requests():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), StallOnce)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        mix = Mix({"request": "infer", "loop": "open", "rate_per_s": 20.0,
                   "max_in_flight": 1, "rows": [[1, 1]], "seq_len": 4,
                   "policy": "soft_vote"}, 0, 10)
        t0 = time.perf_counter() + 0.05
        res = load.run_window(mix, "127.0.0.1", srv.server_address[1],
                              "/x", lambda t: b"{}", t0, 2.0, 10.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(res) == 40 and all(r.ok for r in res)
    after = [r for r in res[3:] if r.due < res[2].done]
    assert after, "requests fell due during the stall"
    for r in after:
        # each waited for the stalled one: due before it ended, sent after
        assert r.lateness_s > 0.05
        assert r.latency_s > res[2].done - r.due
    service = [r.done - r.sent for r in res]
    assert max(r.latency_s for r in after) > 5 * np.median(service)


# --- the metrics' arithmetic -------------------------------------------------


def fake_run(trace=True):
    arch = spec.load_config("yi9b-pair")
    tok = np.ones((16, 512), np.int32)
    mk = lambda due, done, st=200: load.Result(None, tok, due, due, done, st)
    results = [mk(0.0, 1.0), mk(0.5, 2.0), mk(1.0, 3.0), mk(1.2, None, None)]
    before = {"coalesce": {"batches_formed": 10, "rows_total": 100,
                           "queue_wait_ms_hist": {"count": 10, "sum": 50.0},
                           "forward_ms_hist": {"count": 10, "sum": 6000.0}}}
    after = {"coalesce": {"batches_formed": 14, "rows_total": 164,
                          "queue_wait_ms_hist": {"count": 18, "sum": 90.0},
                          "forward_ms_hist": {"count": 14, "sum": 8400.0}}}
    prof = Profile(2.0, 1.5, kernels=[
        ("void (anonymous namespace)::flash_attention_wgmma_kernel<1>(int)",
         0.0, 0.004)] * 96 + [("nvjet_x", 0.0, 0.1)])
    return SimpleNamespace(
        config=arch, traffic=spec.load_traffic("bulk"), results=results,
        answered=results[:3], t_start=0.0, seconds=2.5, last_done=3.0,
        setup_s=12.5, stats_before=before, stats_after=after,
        profile=prof if trace else None,
        forwards=[(16, 0), (16, 4), (16, 8), (16, 0)])


def metric(name):
    return spec.metric_module(name).read


def test_end_to_end_metrics_arithmetic():
    run = fake_run()
    for name in ("infer_rows_per_s", "overload_rows_per_s"):
        assert metric(name)(run) == pytest.approx(48 / 3.0)
    lat = [1000.0, 1500.0, 2000.0, 1e3 * readers.FAILED_LATENCY_S]
    assert metric("infer_p50_ms")(run) == pytest.approx(np.percentile(lat, 50))
    assert metric("infer_p95_ms")(run) == pytest.approx(np.percentile(lat, 95))
    assert metric("setup_s")(run) == 12.5


def test_per_layer_metrics_arithmetic():
    from perfbench.costs import flops, k1, peaks
    run = fake_run()
    assert metric("rows_per_forward")(run) == 64 / 4
    assert metric("padded_rows")(run) == pytest.approx(100 * 12 / 64)
    useful = 64 * 2 * flops.row_flops(run.config["arch"], 512)
    mfu = 100 * useful / (2.4 * peaks.BF16_FLOPS)
    for name in ("forward_mfu.bulk", "forward_mfu.interactive"):
        assert metric(name)(run) == pytest.approx(mfu)
    bound = k1.launch_bound_s(16, 512, 32, 4, 128, 2)
    assert metric("k1_roofline")(run) == pytest.approx(
        100 * 96 * bound / (96 * 0.004))
    for name in ("device_idle.bulk", "device_idle.interactive"):
        assert metric(name)(run) == pytest.approx(25.0)
    lat = [1000.0, 1500.0, 2000.0, 1e3 * readers.FAILED_LATENCY_S]
    assert metric("overload_p95_ms")(run) == pytest.approx(
        np.percentile(lat, 95))


def test_readers_return_nothing_with_nothing_to_read():
    run = fake_run(trace=False)
    for name in ("k1_roofline", "device_idle.bulk",
                 "device_idle.interactive"):
        assert metric(name)(run) is None
    run = fake_run()
    run.traffic = INTERACTIVE        # forwards of many shapes: no one bound
    assert metric("k1_roofline")(run) is None
    run.profile.kernels = []
    assert metric("k1_roofline")(run) is None
    run.forwards = []
    assert metric("padded_rows")(run) is None
    run = fake_run()
    run.profile.kernels = []        # a trace that lost the device's kernels
    assert metric("device_idle.bulk")(run) is None


# --- the trace's reduction ---------------------------------------------------


def test_reduce_trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void a<1>(int)", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 1000, "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 100,
         "dur": 900},
        {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 600,
         "dur": 200},
    ]
    p = reduce_trace(ev, window_s=2e-3)
    assert p.busy_s == pytest.approx(750e-6)
    assert p.device_ops[0] == ("b", pytest.approx(600e-6))
    assert dict(p.device_ops)["gpu_memcpy"] == pytest.approx(100e-6)
    # gaps 150-400 (mid 275: outer) and 500-1000 (mid 750: inner)
    assert dict(p.idle_gaps) == {"aten::outer": pytest.approx(250e-6),
                                 "aten::inner": pytest.approx(500e-6)}
    assert p.kernel_time("a") == (1, pytest.approx(100e-6))


def test_the_window_annotation_bounds_the_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
         "ts": 100, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 300, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1050, "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 420,
         "dur": 500},
    ]
    p = reduce_trace(ev, window_s=99.0)
    assert p.window_s == pytest.approx(1e-3)
    # 100-150, 300-400 and 1050-1100 inside the window
    assert p.busy_s == pytest.approx(200e-6)
    # only the launch wholly inside counts for a kernel's roofline
    assert p.kernel_time("k1") == (1, pytest.approx(100e-6))
    assert dict(p.idle_gaps) == {"no host op recorded":
                                 pytest.approx(150e-6),
                                 "aten::mm": pytest.approx(650e-6)}


def test_a_trace_without_kernels_is_taken_again(monkeypatch):
    from perfbench.harness import profile as prof_mod
    got = [Profile(1.0, 0.0), Profile(1.0, 0.5, kernels=[("k", 0.0, 0.5)])]
    monkeypatch.setattr(prof_mod.SubWindow, "_trace",
                        lambda self, all_threads: got[self.attempts - 1])
    sub = prof_mod.SubWindow(time.perf_counter(), 0.01,
                             time.perf_counter() + 10.0)
    sub()
    assert sub.attempts == 2 and sub.profile.busy_s == 0.5
    # no time left in the window: the first trace stands
    sub = prof_mod.SubWindow(time.perf_counter(), 0.01,
                             time.perf_counter() + 0.1)
    sub()
    assert sub.attempts == 1 and sub.profile.busy_s == 0.0


def test_short_names():
    assert short_name("void (anonymous namespace)::flash_attention_wgmma_"
                      "kernel<128, (bool)1>(CUtensorMap, int)") \
        == "flash_attention_wgmma_kernel"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::(anonymous namespace)::f<float>>(int)") \
        == "at::native::vectorized_elementwise_kernel"
    assert short_name("nvjet_tst_192x192") == "nvjet_tst_192x192"


# --- parts found by name -----------------------------------------------------


def test_a_new_cell_is_found_by_name(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mixed = [[128, 1], [512, 1], [2048, 1]]
    (tmp_path / "perfbench" / "traffic" / "mixed-len.json").write_text(
        json.dumps(dict(INTERACTIVE, seq_len=mixed)))
    bench["workloads"].append({"name": "yi9b-pair.mixed-len",
                               "config": "yi9b-pair", "traffic": "mixed-len",
                               "chips": 1, "why": "mixed lengths"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("yi9b-pair.mixed-len", tmp_path)
    assert cell.traffic["seq_len"] == mixed
    assert cell.config["name"] == "yi9b-pair"
    # metrics that list no cells are reported in it; listed ones are not
    assert {m["name"] for m in cell.end_to_end} == {
        m["name"] for m in bench["end_to_end"] if "workloads" not in m}
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in bench["per_layer"] if "workloads" not in m}
    with pytest.raises(spec.SpecError):
        spec.load_cell("nope.cell", tmp_path)


# --- BENCHMARK.json ----------------------------------------------------------


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for e in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.valid_name(n) for n in names), names
    for k in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[k]}) == len(BENCH[k])
        for m in BENCH[k]:
            assert spec.valid_unit(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_every_metric_file_agrees_with_benchmark_json():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
        if m in BENCH["per_layer"]:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            assert m["moves"] in e2e
            # each cell that reports it reports what it moves
            for c in m.get("workloads", cells):
                assert spec.reports(next(e for e in BENCH["end_to_end"]
                                         if e["name"] == m["moves"]), c)
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        per = {m["name"] for m in cell.per_layer}
        assert per and "setup_s" in {m["name"] for m in cell.end_to_end}


def test_each_config_file_is_named_in_benchmark_json():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


# --- what the benchmark may import -------------------------------------------


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def harness_files():
    return [p for p in PERFBENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_harness_module_imports_jax_or_the_jax_package():
    for p in harness_files():
        bad = set(imported_tops(p)) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_program():
    for p in (PERFBENCH / "reference").glob("*.py"):
        tops = set(imported_tops(p))
        assert not tops & {"repro_torch", "repro", "perfbench"}, (p, tops)


# --- the benchmark's weights are laid out as the port's ----------------------


@pytest.mark.parametrize("name", ["yi9b-pair", "danube-pair"])
def test_weight_layout_is_the_ports(name):
    from repro_torch.serving.lifecycle import default_factory
    from perfbench.apps import ensemble
    cfg = spec.load_config(name)
    for arch_name in cfg["members"]:
        model, _, nc = default_factory({"config": arch_name,
                                        "reduced": cfg["port_reduced"],
                                        "num_classes": cfg["num_classes"]})
        ensemble.check_layout(model.like(),
                              wmod.dense_gqa_layout(cfg["arch"]), arch_name)
        ensemble.check_arch(model.config, cfg["arch"])
        assert nc == cfg["num_classes"]
    bad = dict(cfg["arch"], d_ff=cfg["arch"]["d_ff"] + 1)
    with pytest.raises(ValueError):
        ensemble.check_layout(model.like(), wmod.dense_gqa_layout(bad), "x")
    with pytest.raises(ValueError):
        ensemble.check_arch(model.config, bad)

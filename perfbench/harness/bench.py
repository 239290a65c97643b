"""One run of one cell: set-up, the measured window, the check, the
result line.  ``run.py`` is the command; this module is what it runs, and
what the tests drive on the CPU at a tiny size."""

from __future__ import annotations

import gc
import http.client
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from perfbench.harness import check
from perfbench.harness import load as loadmod
from perfbench.harness import spec as specmod
from perfbench.harness.profile import Profile, SubWindow
from perfbench.harness.traffic import Mix, rng

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# how long past the close the answers of requests sent in the window are
# waited for: a late answer is late, not wrong
GRACE_S = 120.0
WARM_PASSES = 2
CHECK_STREAM = 9


@dataclass
class Run:
    """Everything a metric's reader may read of one run."""

    cell: specmod.Cell
    seed: int
    seconds: float
    trace: bool
    setup_s: float
    t_start: float
    results: List[loadmod.Result]
    stats_before: Dict[str, Any]
    stats_after: Dict[str, Any]
    profile: Optional[Profile] = None
    # (rows, of which padding) of each forward in the window
    forwards: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    @property
    def t_end(self) -> float:
        return self.t_start + self.seconds

    @property
    def answered(self) -> List[loadmod.Result]:
        return [r for r in self.results if r.ok]

    @property
    def last_done(self) -> float:
        done = [r.done for r in self.results if r.done is not None]
        return max([self.t_end] + done)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: ``repro_torch`` is
    not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def get_json(host: str, port: int, path: str) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def nvidia_smi() -> str:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def sample_rows(results: List[loadmod.Result], n: int, seed: int,
                t_late: float) -> List[np.ndarray]:
    """One row from each of ``n`` answered requests, drawn from the seed
    across the whole window: the longest request, one due at ``t_late``
    or after (the window's last third), the rest at random.  Further rows
    of the same requests only where fewer than ``n`` were answered."""
    ok = [r for r in results if r.ok]
    if not ok:
        return []
    g = rng(seed, CHECK_STREAM)
    order = [int(i) for i in g.permutation(len(ok))]
    longest = max(order, key=lambda i: ok[i].tokens.shape[1])
    late = [i for i in order if ok[i].due >= t_late][:1]
    picks = list(dict.fromkeys([longest] + late + order))[:n]
    first = {i: int(g.integers(ok[i].tokens.shape[0])) for i in picks}
    rows: List[np.ndarray] = []
    for k in range(max(ok[i].tokens.shape[0] for i in picks)):
        for i in picks:
            tok = ok[i].tokens
            if k < tok.shape[0] and len(rows) < n:
                rows.append(tok[(first[i] + k) % tok.shape[0]])
    return rows


def reference_logits(ref_mod, weights, rows: List[np.ndarray], config,
                     device) -> List[np.ndarray]:
    """The plain reference's class logits of ``rows`` for each member,
    float64 on the host; rows of one length go through it together."""
    C = int(config["num_classes"])
    import torch
    refs = [np.empty((len(rows), C)) for _ in weights]
    for seq in sorted({len(r) for r in rows}):
        idx = [i for i, r in enumerate(rows) if len(r) == seq]
        tok = torch.from_numpy(np.stack([rows[i] for i in idx])).to(device)
        for w, ref in zip(weights, refs):
            ref[idx] = ref_mod.class_logits(w, tok, config["arch"],
                                            C).double().cpu().numpy()
    return refs


def run(cell: specmod.Cell, seed: int, seconds: float, trace: bool,
        device, t0: float, log=print
        ) -> Tuple[Dict[str, Any], List[str], Run]:
    """One run; returns (the result line's object, the check lines, the
    run's record)."""
    import torch

    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    t_cuda = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    log(f"set-up: interpreter and imports {t_cuda - t0:.3f} s, the "
        f"card's context {time.perf_counter() - t_cuda:.3f} s")
    app_mod = specmod.part_module("apps", config["app"])
    req_mod = specmod.part_module("requests", traffic["request"])
    ref_mod = specmod.part_module("reference", config["reference"])
    mix = Mix(traffic, seed, config["arch"]["vocab_size"])
    encode = req_mod.encoder(traffic["policy"])

    t_in = time.perf_counter()
    dep = app_mod.build(config, seed, device, trace)
    t_built = time.perf_counter()
    log(f"set-up: the app {t_built - t_in:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in dep.timings.items()) + ")")
    warm_up(dep, mix, req_mod.PATH, encode)
    if cuda:
        torch.cuda.synchronize()
    log(f"set-up: warm-up {time.perf_counter() - t_built:.3f} s")

    if trace:
        SubWindow.prepare()
    stats_before = get_json(dep.host, dep.port, "/metrics")
    launches_before = dep.launches()
    dep.recorder.on = True
    t_start = time.perf_counter() + 0.05
    setup_s = t_start - t0
    sub = (SubWindow(t_start + 0.4 * seconds,
                     min(3.0, max(1.5, 0.1 * seconds)), t_start + seconds)
           if trace else None)
    results = loadmod.run_window(mix, dep.host, dep.port, req_mod.PATH,
                                 encode, t_start, seconds, GRACE_S,
                                 during=sub)
    dep.recorder.on = False
    if trace:
        log(f"traced sub-window: {sub.attempts} attempt(s)")
    stats_after = get_json(dep.host, dep.port, "/metrics")
    forwards = (stats_after["coalesce"]["batches_formed"]
                - stats_before["coalesce"]["batches_formed"])
    for k, v in dep.launches().items():
        log(f"launches of {k} per forward: "
            f"{(v - launches_before[k]) / max(forwards, 1):.2f} "
            f"over {forwards} forwards")
    if cuda:
        log(f"card: {nvidia_smi()}")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": int(
                       torch.cuda.max_memory_allocated() if cuda else 0)}
    record = Run(cell, seed, seconds, trace, setup_s, t_start, results,
                 stats_before, stats_after,
                 sub.profile if sub is not None else None)
    if trace:
        device_info["busy_s"] = min(sub.profile.busy_s, sub.profile.window_s)
        device_info["window_s"] = sub.profile.window_s

    # the program's answers and the logits behind them, then the program's
    # state freed before the reference runs (it sets no peak)
    program, record.forwards = dep.recorder.read()
    members = list(dep.member_names)
    wrong = sum(answer_errors(r, members, program, req_mod,
                              traffic["policy"]) for r in results if r.ok)
    never = sum(1 for r in results if r.done is None)
    rows = sample_rows(results, int(config["check"]["ref_rows"]), seed,
                       t_start + 2.0 * seconds / 3.0)
    missing = np.full(config["num_classes"], np.nan, np.float32)
    prog_logits = [np.array([program.get(row.tobytes(), {}).get(m, missing)
                             for row in rows]) for m in members]
    weights = dep.weights
    dep.close()
    del dep, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the plain reference, on the same weights and token ids
    t_ref = time.perf_counter()
    err = check.MISSING
    if rows:
        err = check.logit_err(prog_logits, reference_logits(
            ref_mod, weights, rows, config, device))
    log(f"reference: {len(rows)} rows x {len(weights)} members in "
        f"{time.perf_counter() - t_ref:.3f} s")

    checks = {"wrong_answers": (wrong, 0),
              "never_answered": (never, 0),
              "logit_err": (err,
                            float(config["check"]["limits"]["logit_err"]))}
    answered = len(record.answered)
    correct = answered > 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": bool(correct), "attempted": len(results),
           "failed": len(results) - answered,
           "metrics": read_metrics(cell, record, trace),
           "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           sub.profile.device_ops],
                            "idle_gaps": [list(x) for x in
                                          sub.profile.idle_gaps]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    log(summary(record))
    lines = [f"check {k} {v!r} limit {lim!r}"
             for k, (v, lim) in checks.items()]
    return out, lines, record


def warm_up(dep, mix: Mix, path: str, encode) -> None:
    """Every shape the mix reaches, ``WARM_PASSES`` times, through the
    route itself (kernel builds, cuBLAS's choices, the allocator's
    growth), so that nothing of that falls in the window."""
    client = loadmod.Client(dep.host, dep.port, timeout=600.0)
    try:
        for rows, seq in dep.warm_shapes(mix.shapes):
            for k in range(WARM_PASSES):
                status, body = client.post(
                    path, encode(mix.warm_tokens(rows, seq, k)))
                if status != 200:
                    raise RuntimeError(f"warm-up request ({rows} x {seq}) "
                                       f"answered {status}: {body[:300]!r}")
    finally:
        client.close()


def answer_errors(res: loadmod.Result, members, program, req_mod,
                  policy: str) -> int:
    """Wrong answers in one response; every answer of its rows where the
    body is not the route's answer at all."""
    w = req_mod.wrong_answers(res.body, res.tokens, members, program, policy)
    return (len(members) + 1) * res.tokens.shape[0] if w is None else w


def read_metrics(cell: specmod.Cell, record: Run,
                 trace: bool) -> Dict[str, Dict[str, Any]]:
    """The cell's metrics of this kind of run, each by its own reader; a
    reader that finds nothing to read leaves its metric out."""
    metrics = {}
    for entry in cell.metrics(trace):
        value = specmod.metric_module(entry["name"]).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    return metrics


def summary(run: Run) -> str:
    """An earlier line of the run's log: counts, latency spread and how
    late the open loop's sender ran."""
    lat = sorted(r.latency_s for r in run.results if r.latency_s is not None)
    late = sorted(r.lateness_s for r in run.results if r.sent)
    parts = [f"requests {len(run.results)}, answered {len(run.answered)}"]
    if lat:
        parts.append(f"latency min {lat[0]:.4f} max {lat[-1]:.4f} s")
    if late:
        parts.append(f"sender late p50 {late[len(late) // 2]:.6f} max "
                     f"{late[-1]:.6f} s")
    if run.profile is not None:
        parts.append(f"trace {run.profile.trace_bytes} bytes, "
                     f"{len(run.profile.kernels)} kernels, busy "
                     f"{run.profile.busy_s:.4f} of "
                     f"{run.profile.window_s:.4f} s")
    return "; ".join(parts)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py                 # one card, no other arguments
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table

Phases (any failure exits non-zero and prints no final result line):

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   comparisons.
2. build: every kernel of the main path is compiled from the checkout's
   sources with nvcc for sm_90a.
3. kernels: each kernel is held against its plain PyTorch version on the
   card at the main path's shapes (yi-9b attention: B=8, S=256, H=32, K=4,
   hd=128, bf16 and fp32) and at the edges (sliding window, ragged
   lengths, S not a multiple of the tile, strided inputs, other head
   dims), then timed beside its plain version and the PyTorch library
   call that computes the same function (SDPA, a yardstick only).
4. main path: ``build_app(["yi-9b", "yi-9b"], full=True)`` — two members
   at full width and depth with random weights from a seed — behind
   ``FlexServeServer`` on an ephemeral port; /v1/infer and /v1/detect at
   batch sizes 1, 3 and 8, some concurrent.  Every response must be 200
   and have the paper schema; the kernel launch counts, zeroed just before
   and read just after, must equal members x layers x forwards.  One
   batch's member logits are then held against the plain path (the same
   forward with the kernels' plain versions) on the card.

The line before the nvidia-smi line is ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# device memory bandwidth.  A card below its 700 W limit runs slower.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

ARCH = "yi-9b"
MEMBERS = 2
NUM_CLASSES = 16
# bf16 comparisons: the tolerance of the JAX kernel tests
# (tests/test_kernels.py); fp32: the same file's fp32 tolerance.
TOL = {"bfloat16": dict(rtol=3e-2, atol=3e-2),
       "float32": dict(rtol=2e-5, atol=2e-5)}
# Member logits after 48 bf16 layers: the kernel and the plain version
# round their bf16 attention outputs differently (one bf16 ulp apart), and
# each layer's difference propagates through the residual stream.  Logits
# are O(1) (|logit| <= ~2.4 with the seeded weights), where a bf16 ulp is
# 0.0156; the first H100 run measured 3.5e-2 and 3.9e-2 (about 2.5 ulps),
# so the bound is 0.1 absolute plus 5e-2 relative.
LOGITS_TOL = dict(rtol=5e-2, atol=1e-1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 3: kernels --------------------------------------------------------


def attention_case(name, B, S, H, K, hd, dtype, *, causal=True, window=None,
                   ragged=False, strided=False, offset=0, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    width = (2 * hd if strided else hd) + offset
    q = torch.randn((B, S, H, width), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, K, width), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, K, width), generator=g, device="cuda").to(dt)
    q, k, v = (t[..., offset:offset + hd] for t in (q, k, v))
    lengths = None
    if ragged:
        lengths = torch.randint(0, S + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        lengths[0] = S
    return dict(name=name, q=q, k=k, v=v, lengths=lengths, causal=causal,
                window=window, dtype=dtype)


def visible_pairs(S, causal, window, lengths, B):
    import torch
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    m = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    if lengths is None:
        return int(m.sum()) * B
    return int((m[None] & (kp[None] < lengths[:, None, None])).sum())


def kernel_phase(failures):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    cases = [
        attention_case("yi-9b bf16 causal", 8, 256, 32, 4, 128, "bfloat16"),
        attention_case("yi-9b fp32 causal", 8, 256, 32, 4, 128, "float32"),
        attention_case("yi-9b bf16 window 64", 8, 256, 32, 4, 128,
                       "bfloat16", window=64),
        attention_case("yi-9b bf16 ragged lengths", 8, 256, 32, 4, 128,
                       "bfloat16", ragged=True),
        attention_case("yi-9b fp32 ragged lengths", 8, 256, 32, 4, 128,
                       "float32", ragged=True),
        attention_case("S=200 bf16 (ragged tile)", 3, 200, 32, 4, 128,
                       "bfloat16"),
        attention_case("S=200 fp32 strided inputs", 3, 200, 32, 4, 128,
                       "float32", strided=True),
        attention_case("S=200 bf16 strided inputs", 3, 200, 32, 4, 128,
                       "bfloat16", strided=True),
        attention_case("bf16 rows not 16-byte aligned", 2, 70, 8, 2, 128,
                       "bfloat16", offset=1),
        attention_case("fp32 non-causal", 2, 130, 8, 2, 64, "float32",
                       causal=False),
        attention_case("danube hd=80 bf16 window 48", 2, 130, 32, 8, 80,
                       "bfloat16", window=48),
        attention_case("hd=32 fp32 S=1", 4, 1, 4, 2, 32, "float32"),
        attention_case("hd=256 bf16 non-causal window 40", 2, 96, 4, 1, 256,
                       "bfloat16", causal=False, window=40),
    ]
    results = []
    for c in cases:
        kw = dict(causal=c["causal"], window=c["window"],
                  lengths=c["lengths"])
        out = flash_attention(c["q"], c["k"], c["v"], **kw)
        ref = flash_attention_plain(c["q"], c["k"], c["v"], **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[c["dtype"]]
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), **tol)
        log(f"[kernels] flash_attention {c['name']}: max_abs_err {err:.3e} "
            f"({'ok' if ok else 'FAIL'}, rtol/atol {tol['rtol']})")
        if not ok:
            failures.append(f"flash_attention {c['name']}: err {err}")
        results.append({"case": c["name"], "max_abs_err": err, "ok": ok})

    main = cases[0]
    q, k, v = main["q"], main["k"], main["v"]
    B, S, H, hd = q.shape
    kw = dict(causal=True, window=None, lengths=None)
    kernel_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, **kw))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    except TypeError:                   # torch without enable_gqa
        library_ms = None
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + q.numel() * q.element_size()
    flops = 4 * hd * H * visible_pairs(S, True, None, None, B)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[main["dtype"]]
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:74 "
                    "(flash_attention_bhsd)",
        "shape": f"B={B} S={S} H={H} K={k.shape[2]} hd={hd} bf16 causal",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "bytes": nbytes,
        "flops": flops,
        "cases": results,
    }
    log(f"[kernels] flash_attention timed at {entry['shape']}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms} ms, "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return [entry]


# --- phase 4: main path --------------------------------------------------------


class Client:
    def __init__(self, host, port):
        self.host, self.port = host, port

    def call(self, method, path, body=None):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=600)
        try:
            data = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()


def check_schema(status, body, n, kind):
    if status != 200:
        raise AssertionError(f"{kind}: HTTP {status}: {body}")
    for i in range(MEMBERS):
        vals = body[f"model_{i}"]
        if len(vals) != n:
            raise AssertionError(f"{kind}: model_{i} has {len(vals)} rows, "
                                 f"expected {n}")
        want = bool if kind == "detect" else str
        if not all(isinstance(x, want) for x in vals):
            raise AssertionError(f"{kind}: model_{i} values not {want}")
    if len(body["ensemble"]) != n or "policy" not in body:
        raise AssertionError(f"{kind}: bad ensemble/policy: {body}")


def main_path_phase(failures, kernels, profile_dir):
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch.serve import build_app
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving import FlexServeServer

    t0 = time.perf_counter()
    app = build_app([ARCH] * MEMBERS, full=True, num_classes=NUM_CLASSES,
                    max_batch=8, seed=0)
    torch.cuda.synchronize()
    cfg = app.registry.get(f"{ARCH}#0").model.config
    layers = cfg.num_layers
    log(f"[main] build_app({[ARCH] * MEMBERS}, full=True): "
        f"{layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} kv, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; no depth cut; "
        f"{time.perf_counter() - t0:.1f}s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ledger = app.ensemble.memory_ledger()
    log("[main] " + ledger.report().replace("\n", "\n[main] "))

    server = FlexServeServer(app).start()
    host, port = server.address
    client = Client(host, port)
    rng = np.random.default_rng(0)

    def toks(n, s):
        return rng.integers(0, cfg.vocab_size, (n, s)).tolist()

    requests = [("infer", toks(1, 32)), ("infer", toks(3, 64)),
                ("infer", toks(8, 256)), ("detect", toks(3, 64)),
                ("detect", toks(8, 256))]
    concurrent_reqs = [("infer", toks(1, 64)) for _ in range(4)] + \
        [("detect", toks(1, 64)) for _ in range(2)]

    def send(kind, tokens):
        body = {"inputs": {"tokens": tokens}}
        if kind == "detect":
            body.update(positive_class=1, threshold=0.05, policy="or")
        t = time.perf_counter()
        status, resp = client.call("POST", f"/v1/{kind}", body)
        return kind, len(tokens), status, resp, time.perf_counter() - t

    try:
        # warm: the first forward per shape grows the allocator
        status, body = client.call("POST", "/v1/infer",
                                   {"inputs": {"tokens": toks(8, 256)}})
        check_schema(status, body, 8, "infer")
        status, m0 = client.call("GET", "/metrics")
        batches0 = m0["coalesce"]["batches_formed"]
        flash_attention.launches = 0            # the main path's run
        results = [send(kind, t) for kind, t in requests]
        with concurrent.futures.ThreadPoolExecutor(len(concurrent_reqs)) as ex:
            futs = [ex.submit(send, kind, t) for kind, t in concurrent_reqs]
            results += [f.result() for f in futs]
        torch.cuda.synchronize()
        launches = flash_attention.launches
        status, m1 = client.call("GET", "/metrics")
        forwards = m1["coalesce"]["batches_formed"] - batches0
        for kind, n, st, resp, dt in results:
            check_schema(st, resp, n, kind)
            log(f"[main] POST /v1/{kind} rows={n}: {st} in "
                f"{1e3 * dt:.1f} ms -> {json.dumps(resp)[:120]}")
        expected = MEMBERS * layers * forwards
        log(f"[main] {len(results)} requests, {forwards} coalesced "
            f"forwards; flash_attention launches {launches} (expected "
            f"members x layers x forwards = {expected})")
        if launches != expected or launches == 0:
            failures.append(f"flash_attention launches {launches} != "
                            f"{expected}")
        kernels[0]["launches"] = launches
        for name in ("/health", "/healthz", "/v1/models"):
            st, body = client.call("GET", name)
            if st != 200:
                failures.append(f"GET {name}: {st} {body}")
        st, body = client.call("POST", "/v1/generate", {"prompts": [[1]]})
        if st != 501 or body["error"]["code"] != "not_ported":
            failures.append(f"/v1/generate: {st} {body}")
    finally:
        server.stop()

    # one batch's member logits: kernel path vs plain path, on the card
    ens = app.ensemble
    batch = {"tokens": np.asarray(requests[1][1], np.int32)}
    kern = ens.forward(batch)
    timed = {"tokens": np.asarray(requests[2][1], np.int32)}
    fwd_ms = host_time_ms(lambda: ens.forward(timed))
    attn_mod.flash_attention = flash_attention_plain
    try:
        plain = ens.forward(batch)
        fwd_plain_ms = host_time_ms(lambda: ens.forward(timed))
    finally:
        attn_mod.flash_attention = flash_attention
    for name in kern:
        a, b = kern[name].float(), plain[name].float()
        err = float((a - b).abs().max())
        ok = (tuple(a.shape) == (3, NUM_CLASSES)
              and bool(torch.isfinite(a).all())
              and torch.allclose(a, b, **LOGITS_TOL))
        log(f"[main] member {name} logits {tuple(a.shape)} vs plain path: "
            f"max_abs_err {err:.3e}, max |logit| {float(b.abs().max()):.3f} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"member {name} logits vs plain: err {err}")
    log(f"[main] one ensemble forward (2 members, B=8, S=256): kernel path "
        f"{fwd_ms:.2f} ms, plain attention path {fwd_plain_ms:.2f} ms "
        f"(host clock around a synchronised forward, median of 5)")
    kernels[0]["ensemble_forward_ms"] = fwd_ms
    kernels[0]["ensemble_forward_plain_ms"] = fwd_plain_ms
    if profile_dir:
        profile_forward(ens, timed, Path(profile_dir))


def host_time_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2]


def profile_forward(ens, batch, out_dir: Path) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ens.forward(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    (out_dir / "ensemble_forward_profile.txt").write_text(table)
    log("[profile] " + table.replace("\n", "\n[profile] "))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one ensemble forward with "
                         "torch.profiler and write the table under DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fa_ops
    t0 = time.perf_counter()
    fa_ops.build()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f}s")
    for name, rec in common.build_log.items():
        log(f"[build] {name}: {rec['seconds']:.1f}s -> {rec['library']}")
        for line in str(rec["ptxas"]).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"[build]   {line.strip()}")

    failures = []
    kernels = kernel_phase(failures)
    main_path_phase(failures, kernels, args.profile)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

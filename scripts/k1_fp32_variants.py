"""Times K1's float32 tensor-core route (TF32 x 3 on mma.sync) against the
CUDA-core kernels it replaced, and against text-replaced variants of its
own source, on one card.  Needs a CUDA card (Hopper) and nvcc.

1. Routes: whisper-base's encoder self-attention (S = Skv = 1500, 8/8
   heads of 64, non-causal, fp32, keys shifted by chip_smoke.KEY_SHIFT),
   the forward at B=8 and the backward at B=2 and B=4 (phase 12 C's
   batch), each launched through the C entries with the route passed
   directly (tc = 1: the tensor-core kernels, tc = 0: the CUDA-core ones),
   in turns (CUDA cores, tensor cores, tensor cores, CUDA cores): CUDA
   events over 20 calls and torch.profiler device time.
2. Whole steps, before and after: one whisper-base prefill at B=8 (64
   prompt tokens, float32 frames) and one training step at B=4 x 64
   tokens (phase 12 C's: loss and backward, remat), full width and
   depth, seeded weights; device time of every kernel and of K1's, with
   the float32 launches on the CUDA cores (``ops.tensor_core_path``
   swapped to refuse float32) and as committed, in turns.
3. Variants: the committed sources (flash_attention.cu,
   flash_attention_bwd.cu, sm90.cuh and kernels/csrc/tf32x3.cuh) with
   text replaced, built beside them from a scratch directory; each is
   checked against the plain version at whisper's shapes
   (chip_smoke.check_flash_case / check_bwd_case) and timed against the
   committed kernels in turns (committed, variant, variant, committed):
   * ``cvt_split``: hi rounded by cvt.rna.tf32 (``tf32x3::split``, as K4
     and K5 round it) instead of the committed integer operations on the
     bit pattern (``split_bits``: the same bits for every finite x);
   * ``fwd_kv64``: the forward streams 64-key tiles instead of 32;
   * ``fwd_min_blocks_4``: the forward asks ptxas for 4 blocks an SM
     (128 registers a thread) instead of 3 (2 at hd 96 and 128);
   * ``fwd_direct_acc``: the forward's P V accumulates straight into O
     (rescaled first) instead of into a tile sum from zero that is then
     added: the tensor cores' fp32 sums then run over every key.
   The ptxas report (registers, spills) of each TF32 kernel is printed.

Prints the card's name and power limit, then one JSON object per part.

    python3 scripts/k1_fp32_variants.py [--variants a,b] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
CSRC = KERNELS / "flash_attention" / "csrc"
FILES = {"flash_attention.cu": CSRC, "flash_attention_bwd.cu": CSRC,
         "sm90.cuh": CSRC, "tf32x3.cuh": KERNELS / "csrc"}

# file -> (old, new, count): each old text occurs `count` times in it
VARIANTS = {
    "cvt_split": {"tf32x3.cuh": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        "  return tf32_rna(x);", 1)]},
    "fwd_kv64": {"flash_attention.cu": [(
        "constexpr int kTfKV = 32; ", "constexpr int kTfKV = 64; ", 1)]},
    "fwd_min_blocks_4": {"flash_attention.cu": [(
        "{ return hd <= 80 ? 3 : 2; }", "{ return 4; }", 1)]},
    "fwd_direct_acc": {"flash_attention.cu": [
        ("for (int e = 0; e < 4; ++e) t[n][e] = 0.f;",
         "for (int e = 0; e < 4; ++e)\n"
         "            t[n][e] = c + n < NT ? oacc[c + n][e] * alpha[e >> 1] "
         ": 0.f;", 1),
        ("oacc[c + n][e] = fmaf(oacc[c + n][e], alpha[e >> 1], t[n][e]);",
         "oacc[c + n][e] = t[n][e];", 1)]},
}
WHISPER = dict(S=1500, H=8, K=8, hd=64)
ROUNDS = ("committed", "variant", "variant", "committed")


def variant_dir(name: str, workdir: Path) -> Path:
    """The variant's four files under ``workdir/name`` (the scratch copy of
    tf32x3.cuh is found before nvcc's -I directory: it lies beside the
    file that includes it)."""
    out = workdir / name
    out.mkdir(parents=True, exist_ok=True)
    for fname, where in FILES.items():
        text = (where / fname).read_text()
        for old, new, count in VARIANTS[name].get(fname, ()):
            if text.count(old) != count:
                raise SystemExit(f"k1_fp32_variants: {old!r} occurs "
                                 f"{text.count(old)} times in {fname}, not "
                                 f"{count}")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    return out


def tf32_ptxas(report: str) -> list:
    """Registers and spills of each TF32 x 3 kernel in a ptxas report."""
    lines, entry = [], None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"((?:flash_attention|dkdv|dq)_tf32_kernel)ILi(\d+)",
                          line)
            entry = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the variants' sources "
                         "(default: a new temporary one)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_fp32_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"[card] {card}", flush=True)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k1-fp32-var-"))
    names = [n for n in args.variants.split(",") if n]
    libs = {"committed": (ops.build(), ops.build_bwd())}
    for name in names:
        d = variant_dir(name, workdir)
        headers = [d / "sm90.cuh", d / "tf32x3.cuh"]
        fwd = common.load_library(f"k1_fp32_{name}",
                                  [d / "flash_attention.cu"], headers)
        bwd = common.load_library(f"k1_fp32_{name}_bwd",
                                  [d / "flash_attention_bwd.cu"], headers)
        for lib, fn, ref in ((fwd, "flash_attention_fwd", libs["committed"][0]),
                             (bwd, "flash_attention_bwd",
                              libs["committed"][1])):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (fwd, bwd)
    ptxas = {"committed": tf32_ptxas(
        str(common.build_log["flash_attention"]["ptxas"])
        + str(common.build_log["flash_attention_bwd"]["ptxas"]))}
    for name in names:
        ptxas[name] = tf32_ptxas(
            str(common.build_log[f"k1_fp32_{name}"]["ptxas"])
            + str(common.build_log[f"k1_fp32_{name}_bwd"]["ptxas"]))
    fwd_names = ("flash_attention_tf32_kernel", "flash_attention_kernel")

    def case(B, seed=0):
        return cs.attention_case("whisper encoder fp32", B, WHISPER["S"],
                                 WHISPER["H"], WHISPER["K"], WHISPER["hd"],
                                 "float32", causal=False, seed=seed,
                                 key_shift=cs.KEY_SHIFT)

    def fwd_call(lib, c, out, tc):
        q, k, v = c["q"], c["k"], c["v"]
        B, S, H, hd = q.shape

        def run():
            status = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, None, 0, B, S, k.shape[1], H, k.shape[2], hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(c["causal"]), 0, hd ** -0.5,
                torch.cuda.current_stream().cuda_stream, tc)
            if status:
                raise RuntimeError(f"flash_attention_fwd: status {status}")
        return run

    def bwd_call(lib, c, o, lse, do, tc):
        q, k, v = c["q"], c["k"], c["v"]
        B, S, H, hd = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")

        def run():
            status = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None, 0, B, S,
                k.shape[1], H, k.shape[2], hd,
                *(s for t in (q, k, v, o, do, dq, dk, dv)
                  for s in t.stride()[:3]),
                int(c["causal"]), 0, hd ** -0.5,
                torch.cuda.current_stream().cuda_stream, tc)
            if status:
                raise RuntimeError(f"flash_attention_bwd: status {status}")
        return run

    def timed(fn, names):
        return {"ms": cs.cuda_time_ms(fn),
                "device_ms": cs.profiled_ms(fn, names)}

    # 1. the two routes in turns
    routes = {}
    c = case(8)
    out = torch.empty_like(c["q"])
    runs = [(tc, timed(fwd_call(libs["committed"][0], c, out, tc), fwd_names))
            for tc in (0, 1, 1, 0)]
    routes["forward B=8"] = runs
    del c, out
    for B in (2, 4):
        c = case(B, seed=1)
        o, lse, do = cs.bwd_inputs(dict(c, lengths=None))
        runs = [(tc, timed(bwd_call(libs["committed"][1], c, o, lse, do, tc),
                           cs.K1_BWD_KERNELS)) for tc in (0, 1, 1, 0)]
        routes[f"backward B={B}"] = runs
        del c, o, lse, do
        torch.cuda.empty_cache()
    for key, runs in routes.items():
        for tc, t in runs:
            print(f"[route] whisper encoder fp32 {key}: "
                  f"{'tensor' if tc else 'CUDA'} cores {t['ms']:.4f} ms "
                  f"(device {t['device_ms']:.4f} ms)", flush=True)
    print(json.dumps({"part": "routes", "card": card, "times": {
        key: [dict(t, tensor_cores=bool(tc)) for tc, t in runs]
        for key, runs in routes.items()}}), flush=True)

    # 2. a whisper prefill and a training step, fp32 K1 on either route
    steps = whole_steps(cs, ops)
    print(json.dumps({"part": "steps", "card": card, **steps}), flush=True)

    # 3. the variants against the committed kernels, in turns
    real_fwd, real_bwd = ops.build, ops.build_bwd

    def use(name):
        ops.build = lambda: libs[name][0]
        ops.build_bwd = lambda: libs[name][1]

    results = {}
    try:
        for name in names:
            use(name)
            fc = case(8)
            ok_f, err_f, _, _ = cs.check_flash_case(fc)
            del fc
            bc = case(2, seed=1)
            r = cs.check_bwd_case(bc)
            del bc
            torch.cuda.empty_cache()
            res = {"check": {"forward_ok": ok_f, "forward_err": err_f,
                             "backward_ok": cs.bwd_case_ok(r),
                             "backward_rel_l2": r["rel_l2"],
                             "tensor_cores": r["tensor_cores"]},
                   "ptxas": ptxas[name], "times": {}}
            c = case(8)
            out = torch.empty_like(c["q"])
            res["times"]["forward B=8"] = [
                dict(timed(fwd_call(libs["committed" if who == "committed"
                                         else name][0], c, out, 1),
                           fwd_names), who=who) for who in ROUNDS]
            del c, out
            for B in (2, 4):
                c = case(B, seed=1)
                use("committed")
                o, lse, do = cs.bwd_inputs(dict(c, lengths=None))
                res["times"][f"backward B={B}"] = [
                    dict(timed(bwd_call(libs["committed" if who ==
                                             "committed" else name][1],
                                        c, o, lse, do, 1),
                               cs.K1_BWD_KERNELS), who=who)
                    for who in ROUNDS]
                del c, o, lse, do
                torch.cuda.empty_cache()
            results[name] = res
            for key, runs in res["times"].items():
                print(f"[variant] {name} {key}: " + ", ".join(
                    f"{t['who']} {t['device_ms']:.4f}" for t in runs)
                    + f" ms device; check {res['check']}", flush=True)
    finally:
        ops.build, ops.build_bwd = real_fwd, real_bwd
    print(json.dumps({"part": "variants", "card": card,
                      "committed_ptxas": ptxas["committed"],
                      "variants": results}), flush=True)
    bad = [n for n, r in results.items()
           if not (r["check"]["forward_ok"] and r["check"]["backward_ok"])]
    if bad:
        print(f"k1_fp32_variants: variants that disagree with the plain "
              f"version: {bad}", flush=True)
    return 0


def whole_steps(cs, ops):
    """Device time of one whisper-base prefill (B=8) and one training
    step (B=4), float32 K1 on the CUDA cores ("before") and as committed
    ("after"), in turns."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("whisper-base")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    r = np.random.default_rng(cs.FRONTEND_SEED)
    F, D = cfg.encdec.encoder_frames, cfg.d_model

    def batch(B):
        toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, 64)).astype(
            np.int32)).cuda()
        frames = torch.from_numpy(r.normal(0, 1, (B, F, D)).astype(
            np.float32)).cuda()
        return toks, frames

    toks, frames = batch(8)
    state = model.init_state(8, 448)

    def prefill():
        with torch.no_grad():
            model.prefill(params, {"tokens": toks, "frames": frames}, state)

    ttoks, tframes = batch(4)
    train = {"tokens": ttoks, "labels": torch.roll(ttoks, -1, 1),
             "frames": tframes}
    leaves = [p for p in params.values() if p.is_floating_point()]

    def step():
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss, _ = model.loss(params, train, remat=True)
        loss.backward()
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None

    real = ops.tensor_core_path

    def cuda_cores(q, *others):
        return q.dtype != torch.float32 and real(q, *others)

    def device(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {"device_ms": cs.device_ms(prof, ()),
                "k1_ms": cs.device_ms(prof, cs.K1_KERNELS),
                "k1_bwd_ms": cs.device_ms(prof, cs.K1_BWD_KERNELS)}

    out = {}
    try:
        for key, fn in (("prefill B=8", prefill), ("train step B=4", step)):
            runs = []
            for who in ("before", "after", "after", "before"):
                ops.tensor_core_path = cuda_cores if who == "before" else real
                runs.append(dict(device(fn), who=who))
            out[key] = runs
            for t in runs:
                print(f"[step] whisper-base {key}, fp32 K1 "
                      f"{'CUDA cores' if t['who'] == 'before' else 'as committed'}"
                      f": device {t['device_ms']:.3f} ms (K1 forward "
                      f"{t['k1_ms']:.3f}, backward {t['k1_bwd_ms']:.3f})",
                      flush=True)
    finally:
        ops.tensor_core_path = real
    del params, state
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())

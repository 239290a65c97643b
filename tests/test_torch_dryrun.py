"""The port's one-card dry-run (``repro_torch/launch/dryrun.py``), its step
counter (``analysis/costs.py``) and the kernels' meta branches, held
against the JAX package on the CPU.

* Bytes equal exactly: every arch's params (``jax.eval_shape`` of the
  JAX init), optimizer state (both moment dtypes) and, for every decode
  and prefill shape with the long-context window, decode state.
* Flops match JAX: reduced yi-9b's prefill, counted by the port less K1's
  recorded flops, equals ``analyze_hlo`` of the JAX prefill compiled on
  one CPU device less its jnp attention dots, within 1%.
* Every kernel wrapper's meta outputs have the plain version's shapes and
  dtypes, and ``costs.record`` fires on the CPU and on meta alike.
* The CLI runs in-process on meta: one combo per family and kind, and
  whisper x long_500k comes out skipped.

The JAX side never imports ``repro.launch.dryrun`` (it sets XLA_FLAGS for
a 512-device subprocess at import): its long-context policy is read from
the source."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo_costs import analyze_hlo
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.training import optimizer as joptimizer
from repro_torch import opt
from repro_torch.analysis import costs
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 reduce_for_smoke)
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba2_ssd import ops as ssd
from repro_torch.kernels.rwkv6_wkv import ops as wkv
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.training import optimizer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread (the suite's parallel
    workers each start torch)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def test_long_context_policy_equals_jax():
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    consts = {}
    for node in ast.parse(src).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in ("LONG_SKIP",
                                                              "LONG_WINDOW")):
            consts[node.targets[0].id] = ast.literal_eval(node.value)
    assert consts == {"LONG_SKIP": dryrun.LONG_SKIP,
                      "LONG_WINDOW": dryrun.LONG_WINDOW}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_opt_and_state_bytes_equal_jax(arch):
    jmodel, model = jbuild_model(jget_config(arch)), build_model(
        get_config(arch))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = model.like()
    assert _bytes(params) == _jax_bytes(jparams)
    for md in (None, "bfloat16"):
        jopt = jax.eval_shape(lambda ps: joptimizer.init(ps, md), jparams)
        assert _bytes(optimizer.init(params, md)) == _jax_bytes(jopt), md
    for name, shape in SHAPES.items():
        if shape.kind == "train" or (name == "long_500k"
                                     and arch in dryrun.LONG_SKIP):
            continue
        step = dryrun.build_step(arch, name)
        window = step.meta.get("window")
        kw = {} if window is None else {"window": window}
        jstate = jmodel.state_specs(shape.global_batch, shape.seq_len, **kw)
        assert _bytes(step.args[-1]) == _jax_bytes(jstate), name
        jbatch = jmodel.input_specs(shape)
        batch = model.input_specs(shape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in batch.items()} == {
            k: (tuple(v.shape), jnp.dtype(v.dtype).name)
            for k, v in jbatch.items()}, name


def test_prefill_flops_match_jax():
    """Reduced yi-9b's prefill, float32, B=2 x S=16: the port's counted
    products less K1's recorded flops against the JAX prefill's
    ``analyze_hlo`` flops less its jnp attention dots (4 B H S^2 hd a
    layer: scores and P V over every (query, key) pair), within 1%."""
    jcfg = jreduce(jget_config("yi-9b"))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    B, S = 2, 16
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([S, S - 5], np.int32)
    jstate = jmodel.init_state(B, S)

    def step(p, t, ln, st):
        return jmodel.prefill(p, {"tokens": t, "lengths": ln}, st)
    hlo = jax.jit(step).lower(jparams, tokens, lengths,
                              jstate).compile().as_text()
    attn = (4 * B * jcfg.num_heads * S * S * jcfg.head_dim
            * jcfg.num_layers)
    want = analyze_hlo(hlo)["flops"] - attn

    from repro.training.checkpoint import _flatten
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    params = from_jax(_flatten(jparams), "cpu")
    state = model.init_state(B, S, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)}
    with torch.no_grad(), costs.Counter() as c:
        model.prefill(params, batch, state)
    k1 = c.kernels["flash_attention"]
    assert k1["calls"] == jcfg.num_layers
    got = c.flops - k1["flops"]
    assert want > 0 and abs(got / want - 1) <= 0.01, (got, want)


# --- the counter and the kernels' meta branches ------------------------------


def test_counter_products_bytes_and_peak():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with costs.Counter() as c:
        y = a @ b                          # 2 m n k flops; 512 + 256 + 128
        t = torch.ones(1000)               # 4000 bytes, freed below
        del t
        y.add_(1.0)                        # in place: no new storage
        v = y.view(-1)                     # a view: no bytes, no storage
    assert c.flops == 2 * 8 * 16 * 4
    # mm reads a and b and writes y; ones writes t; add_ reads y and
    # writes it (its scalar is no tensor); the view moves nothing
    assert c.bytes == 4 * (128 + 64 + 32) + 4000 + 4 * (32 + 32)
    # y (128 bytes) and t (4000), each rounded up to ALLOC_ROUND
    assert c.peak == costs._round(128) + costs._round(4000)
    assert c.live == costs._round(128)
    assert v.shape == (32,)
    assert costs.Counter._active is None
    assert costs.storage_bytes([y, v, y[1:]]) == costs._round(128)
    with costs.record("k", 1.0, 2):       # no counter: nothing happens
        pass


def _k1_inputs(dev, grad=False):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 16, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)))
    return [t.to(dev).requires_grad_(grad) for t in (q, k, v)]


def _calls():
    """Each wrapper with inputs made on a device: (name, kernel, fn(dev))."""
    def k1(dev):
        return fa.flash_attention(*_k1_inputs(dev), window=8)

    def k1_grad(dev):
        q, k, v = _k1_inputs(dev, grad=True)
        out = fa.flash_attention(q, k, v)
        return (out, *torch.autograd.grad(out.sum(), (q, k, v)))

    def k1_bwd(dev):
        q, k, v = _k1_inputs(dev)
        o, do = torch.ones_like(q), torch.ones_like(q)
        lse = torch.zeros(2, 4, 16)
        return fa.flash_attention_bwd(q, k, v, o.to(dev), lse.to(dev),
                                      do.to(dev))

    def k2(dev):
        q = torch.ones(3, 8, 64, dtype=torch.bfloat16)
        ck = torch.ones(3, 40, 2, 64, dtype=torch.bfloat16)
        lens = torch.tensor([40, 3, 17], dtype=torch.int32)
        return da.decode_attention(*(t.to(dev) for t in (q, ck, ck, lens)))

    def k3(dev):
        q = torch.ones(2, 8, 64, dtype=torch.bfloat16)
        pages = torch.ones(6, 16, 2, 64, dtype=torch.bfloat16)
        table = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
        lens = torch.tensor([20, 40], dtype=torch.int32)
        return da.paged_decode_attention(
            *(t.to(dev) for t in (q, pages, pages, table, lens)))

    def k4_ins(dev, grad=False):
        B, T, H, N = 2, 40, 2, 64
        ins = [torch.full((B, T, H, N), 0.1) for _ in range(3)]
        ins += [torch.full((B, T, H, N), -0.5), torch.zeros(H, N),
                torch.zeros(B, H, N, N)]
        return [t.to(dev).requires_grad_(grad) for t in ins]

    def k4(dev):
        return wkv.wkv6(*k4_ins(dev))

    def k4_grad(dev):
        ins = k4_ins(dev, grad=True)
        y, sT = wkv.wkv6(*ins)
        return torch.autograd.grad(y.sum(), ins)

    def k5_ins(dev, grad=False):
        B, T, H, P, N = 2, 40, 3, 64, 64
        ins = [torch.full((B, T, H, P), 0.1), torch.full((B, T, H), 0.2),
               -torch.ones(H), torch.full((B, T, N), 0.1),
               torch.full((B, T, N), 0.1), torch.zeros(B, H, P, N)]
        return [t.to(dev).requires_grad_(grad) for t in ins]

    def k5(dev):
        return ssd.ssd(*k5_ins(dev))

    def k5_grad(dev):
        ins = k5_ins(dev, grad=True)
        y, hT = ssd.ssd(*ins)
        return torch.autograd.grad(y.sum(), ins)

    return [("k1", {"flash_attention": 1}, k1),
            ("k1_grad", {"flash_attention": 1}, k1_grad),
            ("k1_bwd", {"flash_attention_bwd": 1}, k1_bwd),
            ("k2", {"decode_attention": 1}, k2),
            ("k3", {"paged_decode_attention": 1}, k3),
            ("k4", {"wkv6": 1}, k4),
            ("k4_grad", {"wkv6": 1}, k4_grad),
            ("k5", {"ssd": 1}, k5),
            ("k5_grad", {"ssd": 1}, k5_grad)]


@pytest.mark.parametrize("name,kernels,fn", _calls(),
                         ids=[c[0] for c in _calls()])
def test_meta_branch_matches_cpu(name, kernels, fn):
    """Meta outputs have the plain version's shapes and dtypes; one
    call is recorded on either device with the same flops and bytes;
    no launch counter moves."""
    counters = (fa.flash_attention, fa.flash_attention_bwd,
                da.decode_attention, da.paged_decode_attention, wkv.wkv6,
                wkv.wkv6_bwd, ssd.ssd, ssd.ssd_bwd)
    before = [f.launches for f in counters]
    seen = {}
    for dev in ("cpu", "meta"):
        with costs.Counter() as c:
            out = fn(dev)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        assert all(t.device.type == dev for t in outs)
        seen[dev] = ([(tuple(t.shape), t.dtype) for t in outs],
                     {k: (v["calls"], v["flops"], v["bytes"])
                      for k, v in c.kernels.items()})
    assert seen["cpu"][0] == seen["meta"][0]
    meta_kernels = seen["meta"][1]
    # on meta the autograd Functions also record the backward kernels
    # (the CPU differentiates the plain versions with autograd's ops)
    for k, n in kernels.items():
        assert meta_kernels[k][0] == n and seen["cpu"][1][k] == meta_kernels[k]
    if name.endswith("_grad"):
        assert set(meta_kernels) - set(kernels) == {
            next(iter(kernels)) + "_bwd"}
    assert [f.launches for f in counters] == before


def test_cost_functions_match_the_launch_shapes():
    c = fa.flash_attention_cost(2, 16, 16, 4, 2, 32, 4, window=8)
    pairs = sum(min(i, 15) - max(0, i - 7) + 1 for i in range(16))
    assert fa.visible_pairs(16, 16, True, 8) == pairs
    assert c.flops == 4 * 32 * 4 * 2 * pairs
    assert c.nbytes == 4 * (2 * 2 * 16 * 4 * 32 + 2 * 2 * 16 * 2 * 32)
    assert fa.visible_pairs(4, 6, False, None) == 24
    assert fa.visible_pairs(6, 3, True, None) == 3 * 6 - 3
    k3 = da.paged_decode_attention_cost(2, 8, 2, 64, 3, 16, 2, 2)
    k2 = da.decode_attention_cost(2, 8, 2, 64, 48, 2, 2)
    assert k3.flops == k2.flops and k3.nbytes == k2.nbytes + 4 * 6
    for cost in (wkv.wkv6_cost(2, 100, 4, 64), wkv.wkv6_bwd_cost(2, 100, 4, 64),
                 ssd.ssd_cost(2, 100, 4, 64, 64),
                 ssd.ssd_bwd_cost(2, 100, 4, 64, 64)):
        assert 0 < cost.products < cost.flops + cost.products
        assert cost.other > 0 and cost.nbytes > 0


# --- the CLI ------------------------------------------------------------------

FAMILY_ARCHS = {"dense": "h2o-danube-1.8b", "moe": "deepseek-v3-671b",
                "ssm": "rwkv6-1.6b", "hybrid": "zamba2-2.7b",
                "vlm": "llama-3.2-vision-11b", "encdec": "whisper-base"}
CLI_COMBOS = [(a, s) for a in FAMILY_ARCHS.values()
              for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CLI_COMBOS)
def test_dryrun_cli_on_meta(arch, shape, tmp_path, capsys):
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(tmp_path)]) == 0
    assert "1/1 OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / f"{arch}.{shape}.gpu1.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "gpu1"
    assert rec["n_devices"] == 1 and rec["collectives"]["total_bytes"] == 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"]) == mem["peak_bytes"]
    # the state the step updates in place is aliased, as JAX donates it
    if shape == "train_4k":      # every argument but the batch and the
        batch = build_model(get_config(arch)).input_specs(SHAPES[shape])
        assert mem["alias_bytes"] == (mem["argument_bytes"]   # step count
                                      - costs.storage_bytes(batch)
                                      - costs.ALLOC_ROUND)
        assert rec["step"] == "train_step"
    else:
        assert mem["alias_bytes"] > 0
    assert rec["params"] == get_config(arch).param_count()
    assert rec["opt_flags"]["ring_cache"] is False       # --opts none
    assert opt.enabled("ring_cache")         # and only for the sweep


def test_dryrun_cli_skips_and_refuses(tmp_path, capsys):
    assert dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "whisper-base.long_500k.gpu1.json")
                     .read_text())
    assert rec["status"] == "skipped"
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "yi-9b", flag])
        assert e.value.code == 2
    capsys.readouterr()


def test_dryrun_cli_jobs_write_the_same_records(tmp_path, capsys):
    """``--jobs 2`` (spawned worker processes) writes the records one
    process writes, the pass's seconds aside."""
    outs = {}
    for jobs in ("1", "2"):
        out = tmp_path / jobs
        assert dryrun.main(["--arch", "whisper-base", "--jobs", jobs,
                            "--out", str(out)]) == 0
        outs[jobs] = {p.name: json.loads(p.read_text())
                      for p in sorted(out.glob("*.json"))}
        for rec in outs[jobs].values():
            rec.pop("trace_s", None)
    assert len(outs["1"]) == len(SHAPES) and outs["1"] == outs["2"]
    assert "4/4 OK" in capsys.readouterr().out

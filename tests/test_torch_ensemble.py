"""The port's ensemble, policies, batching and memory ledger against the
JAX package's, on the CPU.

Both ensembles hold the same three reduced yi-9b members (JAX init,
carried over with ``params.from_jax``).  Logits are compared at 1e-4 (as
in test_torch_transformer.py); class ids and detections only where the
decision margin exceeds 1e-3, so that a near-tie cannot flip on
summation order alone.
"""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_model
from repro.core import Ensemble as JEnsemble
from repro.core import EnsembleMember as JMember
from repro.core import policies as jpol
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import Ensemble, EnsembleMember, MemoryLedger
from repro_torch.core import policies as tpol
from repro_torch.core.batching import to_numpy
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.serving.api import encode_response, to_jsonable


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


C = 8
MARGIN = 1e-3
WEIGHTS = np.array([0.5, 0.2, 0.3])


@pytest.fixture(scope="module")
def pair():
    """(jax ensemble, torch ensemble) over the same member weights."""
    cfg, jmodel, _ = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    jm, tm = [], []
    for i in range(3):
        jp = jmodel.init(jax.random.PRNGKey(100 + i))

        def japply(p, batch, _m=jmodel):
            return _m.forward(p, batch)[:, -1, :C]

        def tapply(p, batch, _m=tmodel):
            return _m.forward(p, batch)[:, -1, :C]

        jm.append(JMember(f"member_{i}", japply, jp, C))
        tm.append(EnsembleMember(f"member_{i}", tapply,
                                 from_jax(_flatten(jp), "cpu"), C))
    return JEnsemble(jm, max_batch=8), Ensemble(tm, max_batch=8)


def _batch(n, seed=0, S=8):
    return {"tokens": np.random.default_rng(seed).integers(
        0, 500, (n, S)).astype(np.int32)}


def _decided(probs):
    """(M, B, C) -> (B,) rows whose top-2 margin exceeds MARGIN in every
    member and in the member mean."""
    ok = np.ones(probs.shape[1], bool)
    for p in list(probs) + [probs.mean(0)]:
        top = np.sort(p, -1)
        ok &= (top[:, -1] - top[:, -2]) > MARGIN
    return ok


def test_forward_logits_match_jax(pair):
    jens, tens = pair
    batch = _batch(5)
    want, got = jens.forward(batch), tens.forward(batch)
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == (5, C)
        assert_allclose(to_numpy(got[name]), np.asarray(want[name]),
                        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("policy", sorted(jpol.PROB_POLICIES))
def test_classify_and_respond_match_jax(pair, policy):
    jens, tens = pair
    batch = _batch(6, seed=1)
    probs = np.stack(list(jens.probs(batch).values()))
    ok = _decided(probs)
    assert ok.any()
    want = jens.classify(batch, policy=policy)
    got = tens.classify(batch, policy=policy)
    np.testing.assert_array_equal(np.asarray(got["ensemble"])[ok],
                                  np.asarray(want["ensemble"])[ok])
    for name in want["members"]:
        np.testing.assert_array_equal(got["members"][name][ok],
                                      np.asarray(want["members"][name])[ok])
    want_resp = jens.respond(batch, policy)
    got_resp = tens.respond(batch, policy)
    assert list(got_resp) == list(want_resp)
    assert got_resp["policy"] == want_resp["policy"] == policy
    for key in want_resp:
        if key != "policy":
            assert ([c for c, d in zip(got_resp[key], ok) if d]
                    == [c for c, d in zip(want_resp[key], ok) if d])


@pytest.mark.parametrize("policy", sorted(jpol.BINARY_POLICIES))
def test_detect_matches_jax(pair, policy):
    jens, tens = pair
    batch = _batch(6, seed=2)
    threshold, cls = 0.12, 1
    probs = np.stack(list(jens.probs(batch).values()))[:, :, cls]
    ok = (np.abs(probs - threshold) > MARGIN).all(0)
    assert ok.any()
    weights = WEIGHTS if policy == "weighted" else None
    want = jens.detect(batch, cls, threshold=threshold, policy=policy,
                       weights=weights)
    got = tens.detect(batch, cls, threshold=threshold, policy=policy,
                      weights=weights)
    np.testing.assert_array_equal(np.asarray(got["ensemble"])[ok],
                                  np.asarray(want["ensemble"])[ok])


def test_policies_take_numpy_and_torch():
    """The port's policies answer the same for numpy arrays and tensors,
    and equal the JAX package's numpy path."""
    rng = np.random.default_rng(0)
    binary = rng.random((3, 9)) > 0.5
    probs = rng.dirichlet(np.ones(5), (3, 9)).astype(np.float32)
    for name, fn in tpol.BINARY_POLICIES.items():
        w = WEIGHTS if name == "weighted" else None
        want = jpol.BINARY_POLICIES[name](binary, w)
        np.testing.assert_array_equal(fn(binary, w), want)
        out = fn(torch.from_numpy(binary), w)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), want)
    for name, fn in tpol.PROB_POLICIES.items():
        for w in (None, WEIGHTS):
            want = jpol.PROB_POLICIES[name](probs, w)
            np.testing.assert_array_equal(fn(probs, w), want)
            np.testing.assert_array_equal(
                fn(torch.from_numpy(probs), w).numpy(), want)


def test_bfloat16_logits_reach_the_host(pair):
    """Logits in bf16 (the full-size dtype) go through to_numpy /
    probs_from_logits / to_jsonable, where np.asarray would fail."""
    logits = {"m": torch.randn(3, C).to(torch.bfloat16)}
    ens_probs = pair[1].probs_from_logits(logits)
    assert ens_probs["m"].dtype == np.float32
    assert_allclose(ens_probs["m"].sum(-1), 1.0, rtol=1e-6)
    body = encode_response({"x": logits["m"], "flag": torch.tensor([True])})
    assert b'"flag": [true]' in body
    assert to_jsonable(torch.tensor([1, 2])) == [1, 2]


def test_variable_batch_sizes_one_count_per_bucket(pair):
    _, tens = pair
    before = dict(tens.compile_counts)
    for n in (1, 2, 3, 5, 8, 7, 4):
        out = tens.forward(_batch(n))
        assert next(iter(out.values())).shape[0] == n
    counts = tens.compile_counts
    assert set(counts) <= set(tens.batch_buckets.sizes)
    assert all(c == 1 for c in counts.values())
    assert tens.num_compilations <= len(tens.batch_buckets.sizes)
    assert set(before) <= set(counts)


def test_set_members_swaps_and_keeps_counts(pair):
    _, tens = pair
    members = tens.members
    swap = Ensemble(members[:2], max_batch=8)
    swap.forward(_batch(2))
    res = swap.set_members(members[::-1], warm_batch=_batch(1))
    assert res["drained"] and res["members"] == [m.name for m in members[::-1]]
    assert list(swap.forward(_batch(2))) == res["members"]
    assert swap.compile_counts[2] == 2         # retired state + new warm


def test_memory_ledger_counts_all_members(pair):
    _, tens = pair
    ledger = tens.memory_ledger(n_chips=2, hbm_per_chip=16 * 2 ** 30)
    assert len(ledger.entries) == len(tens.members)
    per_member = sum(t.numel() * t.element_size()
                     for t in tens.members[0].params.values())
    assert ledger.entries[0].total_bytes == per_member
    assert ledger.bytes_per_chip == 3 * per_member // 2
    assert ledger.fits()
    assert "FITS" in ledger.report()


def test_memory_ledger_needs_a_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="hbm_per_chip"):
        MemoryLedger(n_chips=1)

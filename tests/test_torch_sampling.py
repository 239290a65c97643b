"""The port's sampling against the JAX package's, on the CPU.

``repro_torch.core.rng`` reimplements the parts of ``jax.random`` that
sampling uses; its integer outputs (threefry words, ``fold_in``,
``PRNGKey``, ``bits``, ``uniform``'s mantissa construction) must be
bit-identical, and gumbel noise equal to within 1e-6 (``log`` differs in
the last ulps between XLA and PyTorch).  ``sample_tokens`` must then pick
the same ids as JAX's for every regime over many seeds, and the host
``TokenSampler`` the same draws from the same numpy rng.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.core import sampling as jsampling
from repro_torch.core import rng
from repro_torch.core import sampling as tsampling
from repro_torch.core.sampling import (SamplingError, SamplingParams,
                                       sample_tokens, sampling_regime)


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


SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1, 2 ** 32 + 5, -1, -5]
jsample_tokens = jax.jit(jsampling.sample_tokens)   # as the JAX engine runs it
TINY = float(np.finfo(np.float32).tiny)


def _key(seed):
    return rng.as_key(rng.base_key(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_matches_prng_key(seed):
    np.testing.assert_array_equal(rng.base_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(tsampling.base_key(seed),
                                  jsampling.base_key(seed))


def test_threefry_words_match_jax():
    r = np.random.default_rng(0)
    k = r.integers(0, 2 ** 32, (2,), dtype=np.uint64).astype(np.uint32)
    counts = r.integers(0, 2 ** 32, (257,), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(k),
                                          jnp.asarray(counts)))
    # threefry_2x32 hashes the two halves of the count vector as word pairs
    x = np.concatenate([counts, np.zeros(1, np.uint32)]).astype(np.int64)
    half = x.size // 2
    o0, o1 = rng.threefry2x32(*(torch.tensor(int(w)) for w in k),
                              torch.from_numpy(x[:half]),
                              torch.from_numpy(x[half:]))
    got = torch.cat([o0, o1]).numpy()[:counts.size]
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_fold_in_bits_uniform_gumbel_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = _key(seed)
    for data in (0, 1, 5, 31, 1000, 2 ** 31 + 3):
        jf = jax.random.fold_in(jk, data)
        tf = rng.fold_in(tk, data)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(
            rng.bits(tf, 1001).numpy(),
            np.asarray(jax.random.bits(jf, (1001,), jnp.uint32)))
        np.testing.assert_array_equal(
            rng.uniform(tf, 1001, minval=TINY).numpy(),
            np.asarray(jax.random.uniform(jf, (1001,), minval=TINY)))
        np.testing.assert_allclose(
            rng.gumbel(tf, 1001).numpy(),
            np.asarray(jax.random.gumbel(jf, (1001,))), rtol=1e-6,
            atol=1e-6)


def test_fold_in_and_bits_are_vectorised_over_keys():
    seeds = [3, 9, 27]
    ctrs = [0, 4, 9]
    keys = rng.as_key(np.stack([rng.base_key(s) for s in seeds]))
    got = rng.bits(rng.fold_in(keys, torch.tensor(ctrs)), 64).numpy()
    for i, (s, c) in enumerate(zip(seeds, ctrs)):
        want = jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(s), c),
                               (64,), jnp.uint32)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_categorical_matches_jax_over_seeds():
    r = np.random.default_rng(1)
    hits = 0
    for seed in range(40):
        logits = (2 * r.standard_normal(97)).astype(np.float32)
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), seed % 5)
        want = int(jax.random.categorical(jk, jnp.asarray(logits)))
        got = int(rng.categorical(rng.fold_in(_key(seed), seed % 5),
                                  torch.from_numpy(logits)))
        hits += got == want
    assert hits == 40


REGIMES = {
    # temperature, top_k, top_p per row (6 rows)
    "greedy": ([0.0] * 6, [0, 5, 0, 3, 0, 0], [1.0, 1.0, 0.5, 1.0, 1.0, 1.0]),
    "plain": ([1.0, 0.7, 1.3, 0.9, 1.0, 0.5], [0] * 6, [1.0] * 6),
    "top_k": ([1.0, 0.7, 1.3, 0.9, 1.0, 0.5], [5, 1, 10, 40, 3, 64],
              [1.0] * 6),
    "top_p": ([1.0, 0.7, 1.3, 0.9, 1.0, 0.5], [0] * 6,
              [0.9, 0.5, 0.95, 0.3, 1.0, 0.8]),
    "mixed": ([0.0, 0.8, 1.0, 1.2, 0.0, 0.6], [0, 50, 5, 0, 3, 10],
              [1.0, 0.9, 1.0, 0.7, 0.5, 0.95]),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_sample_tokens_matches_jax_over_seeds(regime):
    """The same ids as JAX's ``sample_tokens`` for 25 seeds x 6 rows."""
    temps, top_k, top_p = (np.asarray(a, dt) for a, dt in
                           zip(REGIMES[regime],
                               (np.float32, np.int32, np.float32)))
    V = 64
    mismatches = []
    for seed in range(25):
        r = np.random.default_rng(100 + seed)
        logits = (3 * r.standard_normal((6, V))).astype(np.float32)
        keys = np.stack([rng.base_key(seed * 6 + i) for i in range(6)])
        ctr = (np.arange(6) + seed).astype(np.int32)
        want = np.asarray(jsample_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k),
            jnp.asarray(top_p), jnp.asarray(keys), jnp.asarray(ctr)))
        got = sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_k), torch.from_numpy(top_p),
            torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(ctr),
            regime=sampling_regime(temps, top_k, top_p, V))
        assert got.dtype == torch.int32
        if not np.array_equal(got.numpy(), want):
            mismatches.append((seed, got.numpy(), want))
    assert mismatches == []


def test_sample_tokens_reads_the_regime_back_when_not_given():
    temps, top_k, top_p = (torch.tensor(a) for a in REGIMES["mixed"])
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 64)).astype(np.float32))
    keys = torch.from_numpy(np.stack([rng.base_key(i) for i in range(6)])
                            .astype(np.int64))
    ctr = torch.zeros(6, dtype=torch.int32)
    a = sample_tokens(logits, temps, top_k.int(), top_p, keys, ctr)
    b = sample_tokens(logits, temps, top_k.int(), top_p, keys, ctr,
                      regime="filtered")
    assert torch.equal(a, b)


def test_sampling_regime():
    V = 64
    assert sampling_regime([0.0, 0.0], [0, 3], [1.0, 0.5], V) == "greedy"
    assert sampling_regime([0.0, 1.0], [0, V], [1.0, 1.0], V) == "plain"
    assert sampling_regime([0.0, 1.0], [0, 5], [1.0, 1.0], V) == "filtered"
    assert sampling_regime([1.0, 1.0], [0, 0], [1.0, 0.9], V) == "filtered"


@pytest.mark.parametrize("filt", ["top_k", "top_p"])
def test_bisection_filters_keep_ties_as_jax(filt):
    """Tied logits at the kth value / boundary probability are all kept."""
    logits = np.array([[3.0, 2.0, 2.0, 2.0, 1.0, 0.0],
                       [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    if filt == "top_k":
        k = np.array([2, 3], np.int32)
        want = jsampling._filter_top_k(jnp.asarray(logits), jnp.asarray(k))
        got = tsampling._filter_top_k(torch.from_numpy(logits),
                                      torch.from_numpy(k))
    else:
        p = np.array([0.6, 0.4], np.float32)
        want = jsampling._filter_top_p(jnp.asarray(logits), jnp.asarray(p))
        got = tsampling._filter_top_p(torch.from_numpy(logits),
                                      torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BODIES = [
    {}, {"temperature": 0.7, "top_k": 20, "top_p": 0.9, "seed": 3,
         "max_new_tokens": 8, "eos_id": 2, "stop": [5, 6]},
    {"temperature": None, "speculation": False},
    {"temperature": -1.0}, {"top_p": 1.5}, {"top_k": -2}, {"seed": "x"},
    {"stop": [1, "a"]}, {"max_new_tokens": 0}, {"temperature": "hot"},
    {"speculation": 1}, {"eos_id": 1.5},
]


@pytest.mark.parametrize("body", BODIES)
def test_sampling_params_from_request_matches_jax(body):
    """Validation, defaults, per-row seeds and describe() agree."""
    try:
        want = jsampling.SamplingParams.from_request(body)
    except jsampling.SamplingError as e:
        with pytest.raises(SamplingError) as got:
            SamplingParams.from_request(body)
        assert str(got.value) == str(e)
        return
    got = SamplingParams.from_request(body)
    assert got.describe() == want.describe()
    assert got.greedy == want.greedy
    for row in range(3):
        assert got.for_row(row).seed == want.for_row(row).seed
    if want.seed is not None:
        assert got.resolve_seed() == want.resolve_seed()


def test_token_sampler_matches_jax_host_reference():
    r = np.random.default_rng(3)
    for params in (dict(), dict(temperature=0.9, seed=1),
                   dict(temperature=1.1, top_k=7, seed=2),
                   dict(temperature=0.8, top_p=0.7, seed=3, stop=(4,),
                        eos_id=9)):
        js = jsampling.SamplingParams(**params).sampler()
        ts = SamplingParams(**params).sampler()
        for _ in range(30):
            row = (2 * r.standard_normal(200)).astype(np.float32)
            assert ts.sample(row) == js.sample(row)
        for t in (4, 9, 0):
            assert ts.is_stop(t) == js.is_stop(t)
    assert len(tsampling.samplers_for(SamplingParams(seed=5), 3)) == 3

"""The port's ``InferenceEngine`` against the JAX package's, on the CPU.

Same weights (the shared conftest's JAX smoke params, carried over with
``params.from_jax``) and the same prompts through both engines at reduced
fp32 sizes: greedy and seeded sampled streams must be token-identical, with
the same finish reasons and step counts.  For h2o-danube the 16-slot ring
cache wraps during the run.  ``insert_rows`` and ``state_batch_axes`` are
held to JAX's on one shared state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.core import InferenceEngine as JEngine
from repro.core import SamplingParams as JSamplingParams
from repro.core import engine as jengine
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import InferenceEngine, SamplingParams
from repro_torch.core import engine as tengine
from repro_torch.models import build_model
from repro_torch.params import flatten, from_jax, state_from_jax, to_flat


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


ARCHS = ["yi-9b", "h2o-danube-1.8b"]
SAMPLINGS = [
    None,                                                     # greedy
    dict(temperature=0.8, top_k=50, top_p=0.9, seed=7, max_new_tokens=20),
    dict(temperature=1.0, seed=3, max_new_tokens=20),        # plain
    dict(temperature=0.7, top_p=0.8, seed=11, max_new_tokens=20),
]


def _engines(arch, **kw):
    _, jmodel, jp = smoke_model(arch)
    model = build_model(reduce_for_smoke(get_config(arch)))
    params = from_jax(_flatten(jp), "cpu")
    return (JEngine(jmodel, jp, max_len=64, max_batch=4, **kw),
            InferenceEngine(model, params, max_len=64, max_batch=4, **kw))


def _prompts(vocab, lengths=(5, 17, 9), seed=5):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, (n,)).tolist() for n in lengths]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("samp", range(len(SAMPLINGS)))
def test_generate_matches_jax_engine(arch, samp):
    jeng, teng = _engines(arch)
    prompts = _prompts(jeng.model.config.vocab_size)
    spec = SAMPLINGS[samp]
    if spec is None:
        want = jeng.generate(prompts, max_new_tokens=20)
        got = teng.generate(prompts, max_new_tokens=20)
    else:
        want = jeng.generate(prompts, sampling=JSamplingParams(**spec))
        got = teng.generate(prompts, sampling=SamplingParams(**spec))
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons
    assert got.steps == want.steps
    assert got.prompt_lengths == want.prompt_lengths
    assert teng.prefill_calls == 1
    assert teng.decode_calls == got.steps - 1


def test_generate_stops_at_eos_like_jax():
    jeng, teng = _engines("yi-9b")
    prompts = _prompts(jeng.model.config.vocab_size, (6, 11))
    first = jeng.generate(prompts, max_new_tokens=12).tokens
    eos = first[0][4]                   # row 0 stops at its 5th token
    want = jeng.generate(prompts, max_new_tokens=12, eos_id=eos)
    got = teng.generate(prompts, max_new_tokens=12, eos_id=eos)
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons
    assert "eos" in got.finish_reasons


@pytest.mark.parametrize("spec", [None, dict(temperature=0.9, seed=2,
                                             max_new_tokens=10)])
def test_host_sampling_path_matches_jax(spec):
    """``device_sampling=False``: the numpy TokenSampler reference loop."""
    jeng, teng = _engines("h2o-danube-1.8b")
    prompts = _prompts(jeng.model.config.vocab_size, (4, 13))
    if spec is None:
        want = jeng.generate(prompts, max_new_tokens=10,
                             device_sampling=False)
        got = teng.generate(prompts, max_new_tokens=10,
                            device_sampling=False)
    else:
        want = jeng.generate(prompts, sampling=JSamplingParams(**spec),
                             device_sampling=False)
        got = teng.generate(prompts, sampling=SamplingParams(**spec),
                            device_sampling=False)
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons


def test_window_override_matches_jax():
    """An engine-level window on a dense arch (non-ring cache, masked)."""
    jeng, teng = _engines("yi-9b", window=6)
    prompts = _prompts(jeng.model.config.vocab_size, (9, 3))
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    assert got.tokens == want.tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_state_batch_axes_matches_jax(arch):
    jeng, teng = _engines(arch)
    assert teng.state_batch_axes() == jeng.state_batch_axes()
    assert teng.state_batch_axes() == {"cache": {"k": 1, "v": 1},
                                       "length": 0}


def test_insert_rows_matches_jax():
    """Both engines scatter the same group state into the same pool."""
    jeng, teng = _engines("yi-9b")
    vocab = jeng.model.config.vocab_size
    pool = jeng.new_state(4)
    _, pool = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8, 8, 8), 1), np.int32))}, pool)
    group = jeng.new_state(2)
    _, group = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8), 2), np.int32)),
        "lengths": jnp.asarray([8, 5], jnp.int32)}, group)
    src = np.array([0, 1, 0, 1], np.int32)
    mask = np.array([False, True, True, False])
    tpool, tgroup = state_from_jax(pool, "cpu"), state_from_jax(group, "cpu")
    want = jeng.insert_rows(pool, group, jnp.asarray(src), jnp.asarray(mask))
    got = teng.insert_rows(tpool, tgroup, src, mask)
    got_flat = to_flat(flatten(got))
    for k, v in _flatten(want).items():
        np.testing.assert_array_equal(got_flat[k], np.asarray(v))
    # the pool passed in is left as it was
    np.testing.assert_array_equal(to_flat(flatten(tpool))["cache/k"],
                                  np.asarray(pool["cache"]["k"]))


def test_decode_cache_size_and_helpers():
    _, teng = _engines("yi-9b")
    assert teng.decode_cache_size() is None
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(tengine.pad_batch_rows(a, 5, fill=1),
                                  jengine.pad_batch_rows(a, 5, fill=1))
    np.testing.assert_array_equal(tengine._pad_rows(a, 4).numpy(),
                                  np.asarray(jengine._pad_rows(a, 4)))
    _, _, jp = smoke_model("yi-9b")
    assert tengine._param_bytes(teng.params) == jengine._param_bytes(jp)


def test_engine_state_lives_with_the_params():
    _, teng = _engines("yi-9b")
    state = teng.new_state(2)
    assert state["cache"]["k"].device == teng.device
    assert state["cache"]["k"].dtype == torch.float32

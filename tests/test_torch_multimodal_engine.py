"""The port's engine and scheduler over the modality-frontend families
(llama-3.2-vision with image embeddings, whisper with audio frames)
against the JAX package's, on the CPU: the extras must flow through the
prefill into the fixed cross-attention K/V, as tests/test_engine_multimodal.py
holds the JAX engine to.

The JAX smoke params (the shared conftest's ``smoke_model``: fp32, 2
layers) are carried over with ``params.from_jax``; vlm's cross gates are
opened (they start at 0, and tanh(0) would silence every image), as the
JAX test opens them.  Checked: ``InferenceEngine.generate(extras=...)``
streams equal the JAX engine's; different images change a vlm stream and
the same frames repeat a whisper stream; ``state_batch_axes`` and
``insert_rows`` equal the JAX engine's on the new state layouts; the
dense ``ContinuousBatchingScheduler`` with per-request extras, one prefill
group whose rows carry different images or frames of one shape, gives the
JAX scheduler's streams and grouping and the port engine's streams; the
paged and speculative engines refuse both families, as the JAX engines do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.core import ContinuousBatchingScheduler as JScheduler
from repro.core import InferenceEngine as JEngine
from repro.core import PagedInferenceEngine as JPaged
from repro.core import SamplingParams as JSamplingParams
from repro.core import SpeculativeEngine as JSpeculative
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, InferenceEngine,
                              PagedInferenceEngine, SamplingParams,
                              SpeculativeEngine)
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


VLM, WHISPER = "llama-3.2-vision-11b", "whisper-base"
EXTRA = {VLM: "image_embeds", WHISPER: "frames"}
MAX_LEN = 64

_ENGINES = {}


def engines(arch):
    """(JAX engine, port engine) over the same smoke params, max_len 64,
    max_batch 4; vlm's gates opened."""
    if arch not in _ENGINES:
        cfg, jmodel, jp = smoke_model(arch)
        if arch == VLM:
            jp = dict(jp)
            jp["cross"] = dict(
                jp["cross"],
                gate_attn=jnp.ones_like(jp["cross"]["gate_attn"]),
                gate_mlp=jnp.ones_like(jp["cross"]["gate_mlp"]))
        tmodel = build_model(reduce_for_smoke(get_config(arch)))
        tp = from_jax(_flatten(jp), "cpu")
        kw = dict(max_len=MAX_LEN, max_batch=4)
        _ENGINES[arch] = (JEngine(jmodel, jp, **kw),
                          InferenceEngine(tmodel, tp, **kw))
    return _ENGINES[arch]


def _extras(arch, n, seed, scale=0.1):
    """n rows of the family's extras from a numpy seed, float32."""
    cfg = smoke_model(arch)[0]
    shape = ((cfg.vlm.image_tokens, cfg.vlm.vision_dim) if arch == VLM
             else (cfg.encdec.encoder_frames, cfg.d_model))
    return np.random.default_rng(seed).normal(
        0, scale, (n, *shape)).astype(np.float32)


@pytest.mark.parametrize("arch,prompts,new", [
    (VLM, [[1, 2, 3], [4, 5]], 4), (WHISPER, [[1, 2]], 5),
    (WHISPER, [[7, 8, 9], [3]], 6)])
def test_generate_with_extras_matches_jax(arch, prompts, new):
    jeng, teng = engines(arch)
    ex = {EXTRA[arch]: _extras(arch, len(prompts), seed=len(prompts))}
    want = jeng.generate(prompts, max_new_tokens=new, extras=ex)
    got = teng.generate(prompts, max_new_tokens=new, extras=ex)
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons
    assert got.steps == want.steps


def test_different_images_change_the_stream():
    """tests/test_engine_multimodal.py's check, on both packages: a second
    image changes the vlm generation, and the port follows JAX's."""
    jeng, teng = engines(VLM)
    prompts = [[1, 2, 3], [4, 5]]
    img = _extras(VLM, 2, seed=0)
    img2 = _extras(VLM, 2, seed=0, scale=0.5)
    a = teng.generate(prompts, max_new_tokens=4,
                      extras={"image_embeds": img})
    b = teng.generate(prompts, max_new_tokens=4,
                      extras={"image_embeds": img2})
    assert a.tokens != b.tokens
    assert b.tokens == jeng.generate(prompts, max_new_tokens=4, extras={
        "image_embeds": img2}).tokens


def test_same_frames_repeat_the_stream():
    _, teng = engines(WHISPER)
    frames = {"frames": _extras(WHISPER, 1, seed=1)}
    a = teng.generate([[1, 2]], max_new_tokens=5, extras=frames)
    b = teng.generate([[1, 2]], max_new_tokens=5, extras=frames)
    assert len(a.tokens[0]) == 5 and a.tokens == b.tokens


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_state_batch_axes_and_insert_rows(arch):
    """Self caches keep batch on axis 2 (vlm: groups, self layers first)
    or 1 (whisper), the image/audio K/V on axis 1, ``length`` on 0, as the
    JAX engine finds them; both engines scatter one prefilled group state
    into the same pool."""
    jeng, teng = engines(arch)
    axes = dict(flatten(teng.state_batch_axes()))
    assert axes == dict(_flatten(jeng.state_batch_axes()))
    assert axes == {"k": 2 if arch == VLM else 1,
                    "v": 2 if arch == VLM else 1, "xk": 1, "xv": 1,
                    "length": 0}
    key = EXTRA[arch]
    tokens = lambda n, t: jnp.asarray(np.full((n, 8), t, np.int32))
    _, pool = jeng.prefill({"tokens": tokens(4, 3),
                            key: jnp.asarray(_extras(arch, 4, seed=2))},
                           jeng.new_state(4))
    _, group = jeng.prefill({"tokens": tokens(2, 5),
                             "lengths": jnp.asarray([8, 5], jnp.int32),
                             key: jnp.asarray(_extras(arch, 2, seed=3))},
                            jeng.new_state(2))
    src = np.array([0, 1, 0, 1], np.int32)
    mask = np.array([False, True, True, False])
    want = jeng.insert_rows(pool, group, jnp.asarray(src), jnp.asarray(mask))
    got = to_flat(flatten(teng.insert_rows(state_from_jax(pool, "cpu"),
                                           state_from_jax(group, "cpu"),
                                           src, mask)))
    for k, v in _flatten(want).items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


def _workload(arch):
    """Four requests of one sequence bucket, their extras two distinct
    rows (requests 0 and 2 share one, 1 and 3 the other), the last
    sampled with a seed."""
    ex = _extras(arch, 2, seed=5, scale=0.3)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11, 12]]
    return [(p, {EXTRA[arch]: ex[i % 2]},
             dict(temperature=0.9, top_k=20, seed=3) if i == 3 else {})
            for i, p in enumerate(prompts)]


def _run(sched_cls, engine, samp_cls, work, new=5):
    s = sched_cls(engine, num_slots=4)
    reqs = [s.submit(p, extras=ex, sampling=samp_cls(max_new_tokens=new,
                                                     **kw))
            for p, ex, kw in work]
    s.run()
    return [r.output for r in reqs], s.prefill_forwards


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_scheduler_streams_with_extras(arch):
    """One prefill group whose rows carry different extras of one shape:
    the port scheduler's streams and grouping equal the JAX scheduler's,
    and its greedy streams equal the port engine's ``generate`` of those
    prompts with their own rows of extras."""
    jeng, teng = engines(arch)
    work = _workload(arch)
    want, jfwd = _run(JScheduler, jeng, JSamplingParams, work)
    got, tfwd = _run(ContinuousBatchingScheduler, teng, SamplingParams,
                     work)
    assert got == want
    assert tfwd == jfwd == 1
    greedy = work[:3]
    ref = teng.generate([p for p, _, _ in greedy], max_new_tokens=5,
                        extras={EXTRA[arch]: np.stack(
                            [ex[EXTRA[arch]] for _, ex, _ in greedy])})
    assert got[:3] == ref.tokens


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_paged_and_speculative_engines_refuse(arch):
    """Neither family pages or speculates, in JAX or in the port."""
    jeng, teng = engines(arch)
    with pytest.raises(ValueError, match="no paged KV path"):
        JPaged(jeng.model, jeng.params, max_len=MAX_LEN, page_size=16)
    with pytest.raises(ValueError, match="no paged KV path"):
        PagedInferenceEngine(teng.model, teng.params, max_len=MAX_LEN,
                             page_size=16)
    with pytest.raises(ValueError, match="dense GQA"):
        JSpeculative(jeng, jeng)
    with pytest.raises(ValueError, match="dense GQA"):
        SpeculativeEngine(teng, teng)

"""The port's whisper-base encoder-decoder (family ``encdec``) against the
JAX package's, on the CPU.

The reduced config (``reduce_for_smoke``: 2 encoder and 2 decoder layers,
16 frames, fp32) with JAX init params carried over by
``params.from_jax``, after every bias (``bq``/``bk``/``bv``/``bo``,
``b_up``/``b_down`` and the LayerNorms' ``nbias``, zeros at init) gets
noise: a bias left out anywhere would otherwise pass unseen.  The same
numpy inputs go through each JAX function and its port:
``sinusoidal_positions``, ``encode`` (the port's bidirectional attention
through K1's plain version), the forward logits (decoder cross-attention
through K1's plain version at Skv = F), prefill + 8 decode steps with
ragged lengths (cross decode through K2's plain version), and the state's
shapes.  Units at 2e-5, logits at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models.layers import sinusoidal_positions as jsinusoidal
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, encdec
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.params import from_jax, unflatten


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


ARCH = "whisper-base"
UNIT = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "nbias")


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduce(jget_config(ARCH))
    tcfg = reduce_for_smoke(get_config(ARCH))
    jmodel = jbuild_model(jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten(
        jmodel.init(jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(11)
    biased = [k for k in flat if k.rsplit("/", 1)[-1] in BIASES]
    assert {k.rsplit("/", 1)[-1] for k in biased} == set(BIASES)
    for k in biased:
        flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(
            flat[k].dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    return jcfg, jmodel, jp, tcfg, build_model(tcfg), from_jax(flat, "cpu")


def _frames(cfg, B, seed=3):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.encoder_frames, cfg.d_model)) * 0.5).astype(
            np.float32)


@pytest.mark.parametrize("num,d", [(16, 256), (1500, 512), (7, 2)])
def test_sinusoidal_positions(num, d):
    got = sinusoidal_positions(num, d, "cpu")
    assert got.dtype == torch.float32 and got.shape == (num, d)
    assert_allclose(got.numpy(), np.asarray(jsinusoidal(num, d)),
                    rtol=0, atol=1e-7)


def test_encode(pair):
    jcfg, _, jp, tcfg, _, tp = pair
    frames = _frames(jcfg, 2)
    want = jencdec.encode(jp, jnp.asarray(frames), jcfg)
    got = encdec.encode(tp, torch.from_numpy(frames), tcfg)
    assert got.shape == frames.shape
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


def test_forward_logits(pair):
    jcfg, jmodel, jp, _, tmodel, tp = pair
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    frames = _frames(jcfg, 2)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(toks),
                               "frames": jnp.asarray(frames)})
    got = tmodel.forward(tp, {"tokens": torch.from_numpy(toks),
                              "frames": torch.from_numpy(frames)})
    assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    other = tmodel.forward(tp, {"tokens": torch.from_numpy(toks),
                                "frames": torch.from_numpy(
                                    _frames(jcfg, 2, seed=8))})
    assert float((other - got).abs().max()) > 1e-3


def test_prefill_then_decode(pair):
    """A ragged prefill (11 and 4 valid tokens) and 8 decode steps: logits
    at every step and the state (self caches, cross K/V, lengths)."""
    jcfg, jmodel, jp, _, tmodel, tp = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    lens = np.asarray([11, 4], np.int32)
    frames = _frames(jcfg, 2)
    js = jmodel.init_state(2, 24)
    jl, js = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lens),
                                 "frames": jnp.asarray(frames)}, js)
    ts = tmodel.init_state(2, 24, device="cpu")
    tl, ts = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens),
                                 "frames": torch.from_numpy(frames)}, ts)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for key in ("xk", "xv"):
        assert_allclose(ts[key].numpy(), np.asarray(js[key]), **UNIT)
    for b, n in enumerate(lens):
        assert_allclose(ts["v"][:, b, :n].numpy(),
                        np.asarray(js["v"])[:, b, :n], **UNIT)
    for _ in range(8):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, js = jmodel.decode(jp, jnp.asarray(tok), js)
        tl, ts = tmodel.decode(tp, torch.from_numpy(tok), ts)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert ts["length"].tolist() == np.asarray(js["length"]).tolist()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_state_layout(pair, device):
    jcfg, jmodel, _, _, tmodel, _ = pair
    want = jax.eval_shape(lambda: jmodel.init_state(3, 20))
    got = tmodel.init_state(3, 20, device=device)
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert t.device.type == device
    assert got["xk"].shape[2] == jcfg.encdec.encoder_frames

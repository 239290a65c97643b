"""The port's flash attention against the JAX package's.

CPU cases: the same numpy inputs through the JAX ``flash_attention``
(Pallas, interpret mode) and ``flash_attention_ref`` and through the
port's wrapper on CPU tensors (its plain version) and its
``flash_attention_ref``.  fp32, tolerance 2e-5 as in tests/test_kernels.py
(the two sides sum in different orders).

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card, fp32 at 2e-5 and bf16 at
3e-2 (tests/test_kernels.py's tolerances).  They need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref)


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


TOL32 = dict(rtol=2e-5, atol=2e-5)

GRID = [(2, 128, 4, 2, 64), (1, 256, 8, 8, 128), (2, 96, 4, 1, 64),
        (1, 130, 2, 2, 32), (3, 1, 4, 2, 32)]
MASKS = [(True, None), (True, 48), (False, None)]


@pytest.fixture(scope="module")
def jax_fa():
    """The JAX package's flash attention (wrapper, oracle) and jnp."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import (flash_attention as jfa,
                                               flash_attention_ref as jref)
    return jfa, jref, jnp


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))


def _lengths(B, S, seed=0):
    lens = np.random.default_rng(seed + 1).integers(1, S + 1, (B,))
    lens[0] = S
    return lens.astype(np.int32)


@pytest.mark.parametrize("B,S,H,K,hd", GRID)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_matches_jax_kernel(jax_fa, B, S, H, K, hd, causal, window,
                                  ragged):
    jfa, _, jnp = jax_fa
    q, k, v = _inputs(B, S, H, K, hd)
    lengths = _lengths(B, S) if ragged else None
    blk = 64 if S >= 64 else 8
    want = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               causal=causal, window=window,
               lengths=None if lengths is None else jnp.asarray(lengths),
               q_blk=blk, kv_blk=blk)
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("B,S,H,K,hd", GRID)
@pytest.mark.parametrize("causal,window", MASKS)
def test_ref_matches_jax_ref(jax_fa, B, S, H, K, hd, causal, window):
    _, jref, jnp = jax_fa
    q, k, v = (np.moveaxis(x, 2, 1) for x in _inputs(B, S, H, K, hd, 1))
    lengths = _lengths(B, S, 1)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, window=window, lengths=jnp.asarray(lengths))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window,
                              lengths=torch.from_numpy(lengths))
    assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_empty_row_gives_zeros():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 12, 4, 2, 32))
    out = flash_attention(q, k, v, lengths=torch.tensor([12, 0],
                                                        dtype=torch.int32))
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(out[0]) > 0


def test_rejects_bad_window_and_devices():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 1, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):     # meta mixed with the CPU
        flash_attention(q.to("meta"), k, v)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, S, H, K, hd, causal, window, ragged, strided, offset
    (8, 256, 32, 4, 128, True, None, False, False, 0),
    (8, 256, 32, 4, 128, True, 64, True, False, 0),
    (3, 200, 32, 4, 128, True, None, False, True, 0),
    (2, 70, 8, 2, 128, True, None, False, False, 1),    # rows not aligned
    (2, 130, 32, 8, 80, True, 48, True, False, 0),
    (2, 130, 8, 2, 64, False, None, False, False, 0),
    (2, 100, 4, 2, 96, False, 30, True, False, 0),
    (4, 1, 4, 2, 32, True, None, False, False, 0),
    (2, 96, 4, 1, 256, False, 40, False, False, 0),
    (2, 300, 96, 8, 128, True, None, False, False, 0),  # G=12
    (4, 300, 32, 4, 128, True, 20, "empty", False, 0),  # window < one tile
    (8, 1024, 32, 4, 128, True, None, False, False, 0), # largest bucket
    (8, 512, 32, 32, 80, True, 4096, False, False, 0),  # zamba2's block
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,ragged,strided,offset",
                         GPU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(cuda, B, S, H, K, hd, causal, window,
                                     ragged, strided, offset, dtype):
    """Both kernel paths: bf16 with head_dim 64/80/96/128 and aligned rows
    takes the tensor cores (wgmma, TMA), everything else the CUDA cores.
    ``ragged == "empty"``: ragged lengths with a row of length 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    width = (2 * hd if strided else hd) + offset
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)[..., offset:offset + hd]
               for x in _inputs(B, S, H, K, width))
    lengths = None
    if ragged:
        lens = _lengths(B, S)
        if ragged == "empty":       # a row that sees no key at all
            lens[1] = 0
        lengths = torch.from_numpy(lens).to(cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          lengths=lengths)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 lengths=lengths)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = TOL32 if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **tol)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 2, 512), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(TypeError):
        h = q[..., :64].half()
        flash_attention(h, h, h)

"""The port's flash attention at Skv != S (cross-attention) against the
JAX package's Pallas kernel.

CPU cases: the same numpy inputs through ``flash_attention_bhsd`` (the
Pallas kernel, interpret mode, 8-row blocks, with q and k/v padded to the
block size and the valid keys given by ``lengths``) and through the
port's wrapper on CPU tensors (its plain version).  Query and key
positions count from 0 on both sides, so causal keeps ``kpos <= qpos``.
fp32 at 2e-5, as tests/test_kernels.py.

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel, both paths, against its plain version at the CPU cases' shapes
and at the cross shapes of llama-3.2-vision (Skv = 1601) and whisper
(Skv = 1500), fp32 at 2e-5 and bf16 at 3e-2, atol scaled by
min(1, max|ref|): outputs averaged over ~1600 keys are ~0.04.  Their
keys are shifted by a constant, which leaves the softmax as it is but
makes a key past Skv that the kernel forgot to mask (TMA zero-fills the
last 64-key tile) outweigh the real ones for many queries; the CPU test
``test_unmasked_key_edge_fails_the_gpu_check`` shows that this data and
tolerance see such a fault.  They need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)


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
TOL16 = dict(rtol=3e-2, atol=3e-2)
BLK = 8
KEY_SHIFT = 2.0         # each query's scores move by N(0, 4)
TILE = 64               # the wgmma kernel's keys per tile


def _inputs(B, S, Skv, H, K, hd, seed=0, key_shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, Skv, K, hd),
                             (B, Skv, K, hd)))
    return q, k + np.float32(key_shift), v


def _scaled_tol(dtype, want):
    """The dtype's tolerance, atol scaled by min(1, max|want|)."""
    tol = TOL32 if dtype == torch.float32 else TOL16
    return dict(rtol=tol["rtol"],
                atol=tol["atol"] * min(1.0, float(np.abs(want).max())))


def _lengths(B, Skv, seed=0):
    """Row 0 sees every key, row 1 a random count, row 2 none."""
    lens = np.random.default_rng(seed + 1).integers(1, Skv + 1, (B,))
    lens[0] = Skv
    if B > 2:
        lens[2] = 0
    return lens.astype(np.int32)


def _pallas(q, k, v, causal, lengths):
    """The Pallas kernel in interpret mode on the model layout: heads moved
    first, Sq and Skv padded to the block size (padded keys are masked by
    ``lengths``; padded queries are cut off)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd
    S, Skv = q.shape[1], k.shape[1]

    def pad(x, n):
        x = np.moveaxis(x, 2, 1)
        return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, n - x.shape[2]),
                                      (0, 0))))
    up = lambda n: -(-n // BLK) * BLK
    out = flash_attention_bhsd(pad(q, up(S)), pad(k, up(Skv)),
                               pad(v, up(Skv)), causal=causal,
                               lengths=jnp.asarray(lengths), q_blk=BLK,
                               kv_blk=BLK, interpret=True)
    return np.moveaxis(np.asarray(out)[:, :, :S], 1, 2)


@pytest.mark.parametrize("Skv", [8, 19, 37])
@pytest.mark.parametrize("S", [16, 5])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,K", [(4, 4), (8, 2)])      # G = 1, 4
def test_plain_matches_pallas_at_skv_ne_s(S, Skv, causal, H, K):
    pytest.importorskip("jax")
    q, k, v = _inputs(3, S, Skv, H, K, 32, seed=Skv + S)
    lengths = _lengths(3, Skv, seed=Skv)
    want = _pallas(q, k, v, causal, lengths)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          lengths=torch.from_numpy(lengths))
    assert got.shape == (3, S, H, 32)
    assert_allclose(got.numpy(), want, **TOL32)
    assert not got[2].any()               # the row with no key: zeros


def test_cross_without_lengths_sees_every_key():
    """lengths None: all Skv keys, the same as lengths = Skv."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 6, 11, 4, 2, 32))
    full = torch.full((2,), 11, dtype=torch.int32)
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       flash_attention(q, k, v, causal=False, lengths=full))


@pytest.mark.parametrize("Skv,hd", [(1601, 128), (1500, 64)])
def test_unmasked_key_edge_fails_the_gpu_check(Skv, hd):
    """An unmasked last tile attends zero keys up to the next multiple of
    64 as well; with shifted keys that moves the output beyond the GPU
    cases' bf16 tolerance."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(
        2, 16, Skv, 8, 2, hd, key_shift=KEY_SHIFT))
    pad = -Skv % TILE
    kz, vz = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
              for t in (k, v))
    want = flash_attention(q, k, v, causal=False).numpy()
    fault = flash_attention(q, kz, vz, causal=False).numpy()
    tol = _scaled_tol(torch.bfloat16, want)
    assert not np.allclose(fault, want, **tol)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, S, Skv, H, K, hd, causal, lengths
    (3, 16, 37, 8, 2, 64, False, "ragged"),
    (3, 5, 19, 4, 4, 128, True, "ragged"),
    (3, 16, 8, 8, 2, 128, True, "ragged"),
    (8, 256, 1601, 32, 8, 128, False, None),    # llama-3.2-vision cross
    (8, 64, 1500, 8, 8, 64, False, None),       # whisper cross
    (8, 1500, 1500, 8, 8, 64, False, None),     # whisper encoder
    (4, 300, 130, 32, 8, 128, False, "ragged"),  # Skv < S, an empty row
    (2, 200, 333, 32, 8, 128, True, None),       # causal, Skv > S
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Skv,H,K,hd,causal,lengths", GPU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_skv_ne_s_on_gpu(cuda, B, S, Skv, H, K, hd,
                                                 causal, lengths, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _inputs(B, S, Skv, H, K, hd, key_shift=KEY_SHIFT))
    lens = (None if lengths is None
            else torch.from_numpy(_lengths(B, Skv)).to(cuda))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, lengths=lens)
    want = flash_attention_plain(q, k, v, causal=causal, lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = want.float().cpu().numpy()
    assert_allclose(got.float().cpu().numpy(), want,
                    **_scaled_tol(dtype, want))

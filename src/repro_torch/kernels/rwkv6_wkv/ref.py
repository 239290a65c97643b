"""Plain PyTorch WKV-6: the version the kernel is held against.

``wkv6_plain`` is the chunked, log-space RWKV-6 recurrence of
``repro/kernels/rwkv6_wkv/kernel.py`` in the model layout, chunk for chunk:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

Inside a chunk the decay between steps s < t is ``exp(Lprev_t - L_s)``
(inclusive / exclusive cumulative sums of log w), an exponent <= 0, never
the division form ``exp(Lprev_t) * exp(-L_s)``.  Lprev_t is taken as
L_{t-1} itself, as the kernel does, not as ``L_t - logw_t`` (the TPU
kernel's form, which under strong decay loses the last bits of the
nearest step's exponent to cancellation).  It materialises the
(B, c, c, H, N) decay tensor of each chunk.  ``wkv6_ref`` is the literal
step-by-step recurrence (the oracle of ``repro/kernels/rwkv6_wkv/ref.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32          # the kernel's chunk (kChunk in csrc/rwkv6_wkv.cu)


def wkv6_plain(r, k, v, logw, u, s0):
    """r/k/v/logw (B,T,H,N), logw <= 0; u (H,N); s0 (B,H,N,N).

    Returns (y (B,T,H,N) fp32, s_T (B,H,N,N) fp32).  T is padded up to a
    chunk multiple with k=v=0 and logw=0, which leaves the state as it
    was; the padded rows of y are dropped."""
    B, T, H, N = r.shape
    c = CHUNK
    Tp = -(-T // c) * c
    r, k, v, logw = (F.pad(t.float(), (0, 0, 0, 0, 0, Tp - T))
                     for t in (r, k, v, logw))
    u = u.float()
    S = s0.float()
    dev = r.device
    tril = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    tril = tril[None, :, :, None, None]                   # s < t
    ys = []
    for j in range(Tp // c):
        sl = slice(j * c, (j + 1) * c)
        r_, k_, v_, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        L = torch.cumsum(lw, dim=1)                       # inclusive
        Lp = F.pad(L[:, :-1], (0, 0, 0, 0, 1, 0))         # exclusive: L_{t-1}
        # D[t,s] = exp(Lprev_t - L_s) for s < t (argument <= 0), else 0
        diff = Lp[:, :, None] - L[:, None, :]             # (B,c,c,H,N)
        D = torch.exp(torch.where(tril, diff, float("-inf")))
        A = (r_[:, :, None] * D * k_[:, None]).sum(-1)    # (B,c,c,H)
        y = torch.einsum("btsh,bshn->bthn", A, v_)
        y = y + (r_ * u * k_).sum(-1, keepdim=True) * v_  # diagonal bonus
        y = y + torch.einsum("bthn,bhnm->bthm", r_ * torch.exp(Lp), S)
        Lc = L[:, -1]                                     # (B,H,N)
        S = (torch.exp(Lc)[..., None] * S
             + torch.einsum("bshn,bshm->bhnm",
                            k_ * torch.exp(Lc[:, None] - L), v_))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], S


def wkv6_ref(r, k, v, logw, u, s0):
    """The literal recurrence, one step at a time, in the model layout
    (B,T,H,N).  Returns (y (B,T,H,N), s_T)."""
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, lw_t = (x[:, t].float() for x in (r, k, v, logw))
        y = (torch.einsum("bhn,bhnm->bhm", r_t, S)
             + (r_t * u * k_t).sum(-1, keepdim=True) * v_t)
        S = torch.exp(lw_t)[..., None] * S + k_t[..., None] * v_t[..., None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), S

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

``wkv6_bwd_plain`` is the backward kernel's formula written out chunk by
chunk (the gradients of every input given dy and dsT); only the tests and
``chip_smoke.py`` call it (on the CPU, autograd differentiates
``wkv6_plain``).
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


def chunk_states(k, v, logw, s0):
    """The state at the start of every chunk and at the end: (B, H,
    nc + 1, N, N) float32, k/v/logw (B,Tp,H,N) already padded."""
    c = CHUNK
    S = s0.float()
    states = [S]
    for j in range(k.shape[1] // c):
        sl = slice(j * c, (j + 1) * c)
        L = torch.cumsum(logw[:, sl], dim=1)
        Lc = L[:, -1]
        S = (torch.exp(Lc)[..., None] * S
             + torch.einsum("bshn,bshm->bhnm",
                            k[:, sl] * torch.exp(Lc[:, None] - L), v[:, sl]))
        states.append(S)
    return torch.stack(states, dim=2)


def wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT=None):
    """The gradients (dr, dk, dv, dlogw (B,T,H,N), du (H,N), ds0 (B,H,N,N))
    of ``wkv6_plain``'s (y, s_T) at these inputs, given dy (B,T,H,N) and
    dsT (B,H,N,N) (None: zero), all float32.

    The adjoint of the state runs backward, dS_{t-1} = diag(w_t) dS_t +
    r_t dy_t^T from dS_T = dsT, a chunk at a time from the state at each
    chunk's start (a forward sweep rebuilds them).  Inside a chunk, with
    D[t,s] = exp(Lprev_t - L_s) (s < t) and Bdy[t,s] = dy_t . v_s:
        dv_s  = sum_{t>s} A[t,s] dy_t + (r_s.(u o k_s)) dy_s
                + (k_s o exp(L_c - L_s))^T dS_end
        dr'_t = sum_{s<t} Bdy[t,s] D[t,s] o k_s + exp(Lprev_t) o S_start dy_t
        dk'_s = sum_{t>s} Bdy[t,s] D[t,s] o r_t + exp(L_c - L_s) o dS_end v_s
    dr and dk add the u bonus's parts, u o k_t (v_t.dy_t) and r_t o u
    (v_t.dy_t), and du = sum over B and T of r o k (v.dy).  The log decay's
    gradient needs no N x N product per step: dlogw_t = dS_t . (S_t -
    k_t v_t^T) row by row, and stepping that back through the chunk gives
        dlogw_t = sum_m S_end[n,m] dS_end[n,m]
                  + sum_{t < tau} r_tau o dr'_tau - sum_{t <= tau} k_tau o dk'_tau
    (tau up to the chunk's end), reverse cumulative sums of the non-bonus
    parts anchored on the chunk's end state against the adjoint from the
    later chunks (S_T . dsT at the last).  Under strong decay the terms
    are far larger than dlogw, which costs precision there
    (scripts/recurrent_bwd_precision.py).  Every exponent is <= 0.  Steps
    past T are k = v = 0, logw = 0, dy = 0."""
    B, T, H, N = r.shape
    c = CHUNK
    Tp = -(-T // c) * c
    nc = Tp // c
    pad = (0, 0, 0, 0, 0, Tp - T)
    dy = torch.zeros_like(r, dtype=torch.float32) if dy is None else dy
    r, k, v, logw, dy = (F.pad(t.float(), pad) for t in (r, k, v, logw, dy))
    u = u.float()
    states = chunk_states(k, v, logw, s0)
    G = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if dsT is None else dsT.float())
    tril = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    tril5 = tril[None, :, :, None, None]                  # s < t
    tril4 = tril[None, :, :, None]
    du = torch.zeros_like(u)
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    for j in reversed(range(nc)):
        sl = slice(j * c, (j + 1) * c)
        r_, k_, v_, lw, dy_ = r[:, sl], k[:, sl], v[:, sl], logw[:, sl], dy[:, sl]
        L = torch.cumsum(lw, dim=1)
        Lp = F.pad(L[:, :-1], (0, 0, 0, 0, 1, 0))
        Lc = L[:, -1]
        D = torch.exp(torch.where(tril5, Lp[:, :, None] - L[:, None, :],
                                  float("-inf")))          # (B,t,s,H,N)
        A = (r_[:, :, None] * D * k_[:, None]).sum(-1)     # (B,t,s,H)
        Bdy = torch.where(tril4, torch.einsum("bthm,bshm->btsh", dy_, v_),
                          0.0)
        vdy = (v_ * dy_).sum(-1, keepdim=True)            # (B,c,H,1)
        bonus = (r_ * u * k_).sum(-1, keepdim=True)
        kd = k_ * torch.exp(Lc[:, None] - L)
        dv[:, sl] = (torch.einsum("btsh,bthm->bshm", A, dy_) + bonus * dy_
                     + torch.einsum("bshn,bhnm->bshm", kd, G))
        drp = (torch.einsum("btsh,btshn,bshn->bthn", Bdy, D, k_)
               + torch.exp(Lp) * torch.einsum("bhnm,bthm->bthn",
                                              states[:, :, j], dy_))
        dkp = (torch.einsum("btsh,btshn,bthn->bshn", Bdy, D, r_)
               + torch.exp(Lc[:, None] - L)
               * torch.einsum("bhnm,bshm->bshn", G, v_))
        dr[:, sl] = drp + u * k_ * vdy
        dk[:, sl] = dkp + r_ * u * vdy
        du += (r_ * k_ * vdy).sum((0, 1))
        anchor = (states[:, :, j + 1] * G).sum(-1)        # (B,H,N)
        rd, kk = r_ * drp, k_ * dkp
        rd_incl = rd.flip(1).cumsum(1).flip(1)            # sum over tau >= t
        kk_incl = kk.flip(1).cumsum(1).flip(1)
        rd_excl = F.pad(rd_incl[:, 1:], (0, 0, 0, 0, 0, 1))
        dlogw[:, sl] = anchor[:, None] + rd_excl - kk_incl
        G = (torch.exp(Lc)[..., None] * G
             + torch.einsum("bthn,bthm->bhnm", r_ * torch.exp(Lp), dy_))
    return (dr[:, :T], dk[:, :T], dv[:, :T], dlogw[:, :T], du, G)

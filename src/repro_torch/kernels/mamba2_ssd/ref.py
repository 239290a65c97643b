"""Plain PyTorch Mamba-2 SSD scan: the version the kernel is held against.

``ssd_plain`` is the chunked SSD of ``repro/kernels/mamba2_ssd/kernel.py``
in the model layout, chunk for chunk (D-skip outside):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T        h: (P, N) per head
    y_t = h_t C_t

Inside a chunk, with L the inclusive cumulative sum of dt*A:
``y = (M o C B^T)(x dt) + exp(L) o (C h^T)`` where ``M[t,s] =
exp(L_t - L_s)`` for s <= t (argument <= 0), and the carried state is
``h' = exp(L_c) h + ((x dt) o exp(L_c - L))^T B``.  ``ssd_ref`` is the
literal step-by-step recurrence (the oracle of
``repro/kernels/mamba2_ssd/ref.py``).

``ssd_bwd_plain`` is the backward kernel's formula written out chunk by
chunk (the gradients of every input given dy and dhT); only the tests and
``chip_smoke.py`` call it (on the CPU, autograd differentiates
``ssd_plain``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32          # the kernels' chunk (kChunk in csrc/mamba2_ssd.cu)


def ssd_plain(x, dt, A, Bm, Cm, h0):
    """x (B,T,H,P); dt (B,T,H) >= 0; A (H,) < 0; Bm/Cm (B,T,N);
    h0 (B,H,P,N).  Returns (y (B,T,H,P) fp32, h_T (B,H,P,N) fp32).

    T is padded up to a chunk multiple with dt=0 (decay 1, no input),
    which leaves the state as it was; the padded rows of y are dropped."""
    Bt, T, H, P = x.shape
    c = CHUNK
    Tp = -(-T // c) * c
    x = F.pad(x.float(), (0, 0, 0, 0, 0, Tp - T))
    dt = F.pad(dt.float(), (0, 0, 0, Tp - T))
    Bm, Cm = (F.pad(t.float(), (0, 0, 0, Tp - T)) for t in (Bm, Cm))
    A = A.float()
    h = h0.float()
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    tril = tril[None, :, :, None]                         # s <= t
    ys = []
    for j in range(Tp // c):
        sl = slice(j * c, (j + 1) * c)
        x_, dt_, B_, C_ = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        L = torch.cumsum(dt_ * A, dim=1)                  # (B,c,H)
        diff = L[:, :, None] - L[:, None, :]              # (B,t,s,H)
        M = torch.exp(torch.where(tril, diff, float("-inf")))
        G = torch.einsum("btn,bsn->bts", C_, B_)          # shared by heads
        W = M * G[..., None]
        xdt = x_ * dt_[..., None]                         # (B,c,H,P)
        y = torch.einsum("btsh,bshp->bthp", W, xdt)
        y = y + torch.exp(L)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                       C_, h)
        Lc = L[:, -1]                                     # (B,H)
        wd = torch.exp(Lc[:, None] - L)                   # (B,c,H)
        h = (torch.exp(Lc)[..., None, None] * h
             + torch.einsum("bshp,bsn->bhpn", xdt * wd[..., None], B_))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


def ssd_ref(x, dt, A, Bm, Cm, h0):
    """The literal recurrence, one step at a time.  Returns (y, h_T)."""
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t = x[:, t].float(), dt[:, t].float()
        B_t, C_t = Bm[:, t].float(), Cm[:, t].float()
        decay = torch.exp(dt_t * A)                       # (B,H)
        h = (decay[..., None, None] * h
             + (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t))
    return torch.stack(ys, dim=1), h


def chunk_states(x, dt, A, Bm, h0):
    """The state at the start of every chunk and at the end: (B, H,
    nc + 1, P, N) float32, x/dt/Bm (B,Tp,...) already padded."""
    c = CHUNK
    h = h0.float()
    states = [h]
    for j in range(x.shape[1] // c):
        sl = slice(j * c, (j + 1) * c)
        L = torch.cumsum(dt[:, sl] * A, dim=1)            # (B,c,H)
        Lc = L[:, -1]
        wd = torch.exp(Lc[:, None] - L) * dt[:, sl]
        h = (torch.exp(Lc)[..., None, None] * h
             + torch.einsum("bshp,bsn->bhpn", x[:, sl] * wd[..., None],
                            Bm[:, sl]))
        states.append(h)
    return torch.stack(states, dim=2)


def ssd_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dhT=None):
    """The gradients (dx (B,T,H,P), ddt (B,T,H), dA (H,), dBm, dCm
    (B,T,N), dh0 (B,H,P,N)) of ``ssd_plain``'s (y, h_T) at these inputs,
    given dy (B,T,H,P) and dhT (B,H,P,N) (None: zero), all float32.

    The adjoint of the state runs backward, G_t = dy_t C_t^T + exp(l_{t+1})
    G_{t+1} with l = dt A, from dhT, a chunk at a time from the state at
    each chunk's start (a forward sweep rebuilds them).  Inside a chunk,
    with L the inclusive cumulative sum of l, M[t,s] = exp(L_t - L_s)
    (s <= t), CB[t,s] = C_t . B_s, X[t,s] = dy_t . x_s and Gc the adjoint
    arriving from the chunks after it:
        dC_t (head h) = exp(L_t) h_start^T dy_t + sum_{s<=t} M X dt_s B_s
        gx_s = exp(L_c - L_s) Gc B_s + sum_{t>=s} M CB dy_t,  dx_s = dt_s gx_s
        dB_s (head h) = dt_s (exp(L_c - L_s) Gc^T x_s + sum_{t>=s} M X C_t)
    dBm and dCm sum the heads.  The log decay's gradient dl_t = exp(l_t)
    G_t . h_{t-1} needs no P x N product per step: expanded over the
    chunk's start state h0 and its inputs, term by term,
        dl_t = exp(L_c) h0 . Gc + sum_{tau>=t} exp(L_tau) C_tau . (h0^T dy_tau)
               + sum_{s<t} exp(L_c - L_s) dt_s x_s . (Gc B_s)
               + sum_{s<t<=tau} M[tau,s] dt_s X[tau,s] CB[tau,s]
    (per head); then ddt = A dl + x . gx and dA = sum over B and T of dt
    dl.  (The same identity also gives dl as a reverse sum of C . dC -
    x . dx; under strong decay its terms are far larger than dl, and its
    rounding misses dA by orders of magnitude more than this form:
    scripts/recurrent_bwd_precision.py.)  Every exponent is <= 0.  Steps
    past T are dt = 0, dy = 0."""
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    c = CHUNK
    Tp = -(-T // c) * c
    nc = Tp // c
    dy = torch.zeros_like(x, dtype=torch.float32) if dy is None else dy
    x, dy = (F.pad(t.float(), (0, 0, 0, 0, 0, Tp - T)) for t in (x, dy))
    dt = F.pad(dt.float(), (0, 0, 0, Tp - T))
    Bm, Cm = (F.pad(t.float(), (0, 0, 0, Tp - T)) for t in (Bm, Cm))
    A = A.float()
    states = chunk_states(x, dt, A, Bm, h0)
    G = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if dhT is None else dhT.float())
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    strict = tril.tril(-1)[None, :, :, None]              # s < t
    tril = tril[None, :, :, None]                         # s <= t
    dA = torch.zeros_like(A)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    for j in reversed(range(nc)):
        sl = slice(j * c, (j + 1) * c)
        x_, dt_, B_, C_, dy_ = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], dy[:, sl]
        L = torch.cumsum(dt_ * A, dim=1)                  # (B,c,H)
        Lc = L[:, -1]
        M = torch.exp(torch.where(tril, L[:, :, None] - L[:, None, :],
                                  float("-inf")))          # (B,t,s,H)
        CB = torch.einsum("btn,bsn->bts", C_, B_)
        X = torch.einsum("bthp,bshp->btsh", dy_, x_)
        MX = M * X
        back = torch.exp(Lc[:, None] - L)                 # (B,c,H)
        hdy = torch.einsum("bthp,bhpn->bthn", dy_, states[:, :, j])
        Gb = torch.einsum("bhpn,bsn->bshp", G, B_)
        dCh = (torch.exp(L)[..., None] * hdy
               + torch.einsum("btsh,bsh,bsn->bthn", MX, dt_, B_))
        gx = (back[..., None] * Gb
              + torch.einsum("btsh,bts,bthp->bshp", M, CB, dy_))
        dBh = dt_[..., None] * (
            back[..., None] * torch.einsum("bhpn,bshp->bshn", G, x_)
            + torch.einsum("btsh,btn->bshn", MX, C_))
        dx[:, sl] = dt_[..., None] * gx
        xg = (x_ * gx).sum(-1)                            # (B,c,H)
        # dl_t = exp(l_t) G_t . h_{t-1}, term by term: the chunk's start
        # state against the adjoint from later chunks, the start state
        # against this chunk's dy C^T, this chunk's inputs against the later
        # adjoint, and its inputs s < t against its dy C^T at tau >= t
        E = torch.exp(L) * (C_[:, :, None] * hdy).sum(-1)          # (B,c,H)
        Fs = back * dt_ * (x_ * Gb).sum(-1)
        Y = torch.where(strict, MX * CB[..., None] * dt_[:, None], 0.0)
        col = Y.flip(1).cumsum(1).flip(1)          # (B,t,s,H): tau >= t
        rect = torch.where(strict, col, 0.0).sum(2)
        dl = (torch.exp(Lc)[:, None]
              * (states[:, :, j] * G).sum((-1, -2))[:, None]
              + E.flip(1).cumsum(1).flip(1)
              + F.pad(Fs.cumsum(1)[:, :-1], (0, 0, 1, 0)) + rect)
        ddt[:, sl] = A * dl + xg
        dA += (dt_ * dl).sum((0, 1))
        dB[:, sl], dC[:, sl] = dBh.sum(2), dCh.sum(2)
        G = (torch.exp(Lc)[..., None, None] * G
             + torch.einsum("bthp,btn->bhpn", dy_ * torch.exp(L)[..., None],
                            C_))
    return dx[:, :T], ddt[:, :T], dA, dB[:, :T], dC[:, :T], G

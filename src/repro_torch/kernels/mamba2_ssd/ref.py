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

``ssd_bwd_plain`` is the backward kernels' formula written out in their
factoring (the gradients of every input given dy and dhT): the states and
the adjoints at the chunk boundaries by two scans (``chunk_states``,
``chunk_adjoints``), then every chunk's terms at once; only the tests and
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


def chunk_adjoints(dy, dt, A, Cm, dhT):
    """The adjoint of the state at the start of every chunk and at the
    end: (B, H, nc + 1, P, N) float32, entry nc dhT and entry j the
    adjoint of chunk j's start state, G_j = exp(L_c) G_{j+1} + (dy o
    exp(L))^T C over chunk j (entry 0 is dh0); dy/dt/Cm (B,Tp,...) already
    padded, dhT (B,H,P,N) float32."""
    c = CHUNK
    G = dhT
    adj = [G]
    for j in reversed(range(dy.shape[1] // c)):
        sl = slice(j * c, (j + 1) * c)
        L = torch.cumsum(dt[:, sl] * A, dim=1)            # (B,c,H)
        G = (torch.exp(L[:, -1])[..., None, None] * G
             + torch.einsum("bthp,btn->bhpn",
                            dy[:, sl] * torch.exp(L)[..., None], Cm[:, sl]))
        adj.append(G)
    return torch.stack(adj[::-1], dim=2)


def ssd_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dhT=None):
    """The gradients (dx (B,T,H,P), ddt (B,T,H), dA (H,), dBm, dCm
    (B,T,N), dh0 (B,H,P,N)) of ``ssd_plain``'s (y, h_T) at these inputs,
    given dy (B,T,H,P) and dhT (B,H,P,N) (None: zero), all float32.

    In the backward kernels' factoring: two scans over the chunk
    boundaries, then every chunk's terms at once.  The scans give the
    state at each chunk's start (``chunk_states``, the forward recurrence)
    and the adjoint of the state at each chunk's end (``chunk_adjoints``,
    G_t = dy_t C_t^T + exp(l_{t+1}) G_{t+1} with l = dt A, from dhT,
    chunk by chunk).  Inside a chunk, with h0 its start state, Gc the
    adjoint arriving at its end, L the inclusive cumulative sum of l,
    M[t,s] = exp(L_t - L_s) (s <= t), CB[t,s] = C_t . B_s and X[t,s] =
    dy_t . x_s:
        dC_t (head h) = exp(L_t) h0^T dy_t + sum_{s<=t} M X dt_s B_s
        gx_s = exp(L_c - L_s) Gc B_s + sum_{t>=s} M CB dy_t,  dx_s = dt_s gx_s
        dB_s (head h) = dt_s (exp(L_c - L_s) Gc^T x_s + sum_{t>=s} M X C_t)
    dBm and dCm sum the heads.  The log decay's gradient dl_t = exp(l_t)
    G_t . h_{t-1} needs no P x N product per step: expanded over h0 and
    the chunk's inputs, term by term,
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
    h0 = h0.float()
    dhT = torch.zeros_like(h0) if dhT is None else dhT.float()
    # the two boundary scans, then (B, nc, ...) views of every chunk
    starts = chunk_states(x, dt, A, Bm, h0)[:, :, :nc].transpose(1, 2)
    adj = chunk_adjoints(dy, dt, A, Cm, dhT)
    Gc = adj[:, :, 1:].transpose(1, 2)                   # (B,nc,H,P,N)
    x_, dy_ = (t.reshape(Bt, nc, c, H, P) for t in (x, dy))
    dt_ = dt.reshape(Bt, nc, c, H)
    B_, C_ = (t.reshape(Bt, nc, c, N) for t in (Bm, Cm))
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    strict = tril.tril(-1)[:, :, None]                   # s < t
    tril = tril[:, :, None]                              # s <= t
    L = torch.cumsum(dt_ * A, dim=2)                     # (B,nc,c,H)
    Lc = L[:, :, -1]                                     # (B,nc,H)
    M = torch.exp(torch.where(tril, L[:, :, :, None] - L[:, :, None, :],
                              float("-inf")))            # (B,nc,t,s,H)
    CB = torch.einsum("bjtn,bjsn->bjts", C_, B_)
    MX = M * torch.einsum("bjthp,bjshp->bjtsh", dy_, x_)
    back = torch.exp(Lc[:, :, None] - L)                 # (B,nc,c,H)
    hdy = torch.einsum("bjthp,bjhpn->bjthn", dy_, starts)
    Gb = torch.einsum("bjhpn,bjsn->bjshp", Gc, B_)
    dCh = (torch.exp(L)[..., None] * hdy
           + torch.einsum("bjtsh,bjsh,bjsn->bjthn", MX, dt_, B_))
    gx = (back[..., None] * Gb
          + torch.einsum("bjtsh,bjts,bjthp->bjshp", M, CB, dy_))
    dBh = dt_[..., None] * (
        back[..., None] * torch.einsum("bjhpn,bjshp->bjshn", Gc, x_)
        + torch.einsum("bjtsh,bjtn->bjshn", MX, C_))
    dx = dt_[..., None] * gx
    xg = (x_ * gx).sum(-1)                               # (B,nc,c,H)
    # dl_t = exp(l_t) G_t . h_{t-1}, term by term: the chunk's start state
    # against the adjoint from later chunks, the start state against this
    # chunk's dy C^T, this chunk's inputs against the later adjoint, and
    # its inputs s < t against its dy C^T at tau >= t (the rectangle: the
    # column sums over tau >= t, then the row sum over s < t)
    E = torch.exp(L) * (C_[:, :, :, None] * hdy).sum(-1)
    Fs = back * dt_ * (x_ * Gb).sum(-1)
    Y = torch.where(strict, MX * CB[..., None] * dt_[:, :, None], 0.0)
    col = Y.flip(2).cumsum(2).flip(2)                    # tau >= t
    rect = torch.where(strict, col, 0.0).sum(3)
    dl = (torch.exp(Lc)[:, :, None] * (starts * Gc).sum((-1, -2))[:, :, None]
          + E.flip(2).cumsum(2).flip(2)
          + F.pad(Fs.cumsum(2)[:, :, :-1], (0, 0, 1, 0)) + rect)
    ddt = A * dl + xg
    dA = (dt_ * dl).sum((0, 1, 2))
    return (dx.reshape(Bt, Tp, H, P)[:, :T], ddt.reshape(Bt, Tp, H)[:, :T],
            dA, dBh.sum(3).reshape(Bt, Tp, N)[:, :T],
            dCh.sum(3).reshape(Bt, Tp, N)[:, :T], adj[:, :, 0])

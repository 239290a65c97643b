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

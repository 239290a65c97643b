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

``wkv6_bwd_plain`` is the backward kernels' formula in their factoring
(the gradients of every input given dy and dsT): the two chunk-boundary
scans (``chunk_states``, ``chunk_adjoints``), then every chunk's terms at
once, A, dr' and dk' between sub-chunks of SUB steps through factored
decays (``subchunk_terms``) and within one exactly (``diag_terms``).  Only
the tests and ``chip_smoke.py`` call it (on the CPU, autograd
differentiates ``wkv6_plain``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32          # the kernel's chunk (kChunk in csrc/rwkv6_wkv.cu)
SUB = 8             # steps per sub-chunk (kSub in the tensor-core kernels)


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


def chunk_states(k, v, logw, s0, product=torch.einsum):
    """The state at the start of every chunk and at the end: (B, H,
    nc + 1, N, N) float32, k/v/logw (B,Tp,H,N) already padded.  Entry j + 1
    is S_j' = exp(L_c) o S_j + (k o exp(L_c - L))^T v over chunk j."""
    c = CHUNK
    S = s0.float()
    states = [S]
    for j in range(k.shape[1] // c):
        sl = slice(j * c, (j + 1) * c)
        L = torch.cumsum(logw[:, sl], dim=1)
        Lc = L[:, -1]
        S = (torch.exp(Lc)[..., None] * S
             + product("bshn,bshm->bhnm",
                       k[:, sl] * torch.exp(Lc[:, None] - L), v[:, sl]))
        states.append(S)
    return torch.stack(states, dim=2)


def chunk_adjoints(r, logw, dy, dsT, product=torch.einsum):
    """The adjoint of the state at the start of every chunk and at the
    end: (B, H, nc + 1, N, N) float32, entry nc dsT and entry j the adjoint
    of chunk j's start state, G_j = exp(L_c) o G_{j+1} + (r o
    exp(Lprev))^T dy over chunk j (entry 0 is ds0); r/logw/dy (B,Tp,H,N)
    already padded, dsT (B,H,N,N) float32."""
    c = CHUNK
    G = dsT
    adj = [G]
    for j in reversed(range(r.shape[1] // c)):
        sl = slice(j * c, (j + 1) * c)
        L = torch.cumsum(logw[:, sl], dim=1)
        Lp = F.pad(L[:, :-1], (0, 0, 0, 0, 1, 0))
        G = (torch.exp(L[:, -1])[..., None] * G
             + product("bthn,bthm->bhnm", r[:, sl] * torch.exp(Lp),
                       dy[:, sl]))
        adj.append(G)
    return torch.stack(adj[::-1], dim=2)


def subchunk_terms(r, k, L, Lp, Bd, product=torch.einsum):
    """The parts of A, dr' and dk' between steps s < t of different
    sub-chunks of SUB steps, in the backward kernel's factoring.  r, k and
    the inclusive (L) and exclusive (Lp) cumulative log decays are (B, nc,
    c, H, N), Bd[t, s] = dy_t . v_s (B, nc, c, c, H).  For q = 1 .. c/SUB -
    1, with b = SUB q - 1 the last step of sub-chunk q - 1,
        R_q[t] = r_t o exp(Lprev_t - L_b)    (t >= SUB q)
        K_q[s] = k_s o exp(L_b - L_s)        (s <= b)
    both exponents <= 0, and exp(Lprev_t - L_s) = exp(Lprev_t - L_b)
    exp(L_b - L_s) for every s <= b < t, so
        A[t, s] = R_q[t] . K_q[s]                          (s in sub-chunk q-1)
        dr'_t  += exp(Lprev_t - L_b) o sum_{s<=b} Bd[t,s] K_q[s]  (t in q)
        dk'_s  += exp(L_b - L_s) o sum_{t>b} Bd[t,s] R_q[t]      (s in q-1)
    (every pair s < t of different sub-chunks once).  Returns (A (B,nc,c,
    c,H), dr', dk' (B,nc,c,H,N))."""
    c = r.shape[2]
    dev = r.device
    idx = torch.arange(c, device=dev)
    q = torch.arange(1, c // SUB, device=dev)
    later = idx[None, :] >= SUB * q[:, None]               # (q, c): t > b
    sub = idx[None, :] // SUB
    last = sub == q[:, None] - 1                           # in sub-chunk q-1
    rows = sub == q[:, None]                               # in sub-chunk q

    def mask(m):                                           # (q,c) -> 6 dims
        return m[None, None, :, :, None, None]
    Lb = L[:, :, SUB * q - 1][:, :, :, None]               # (B,nc,q,1,H,N)
    R = r[:, :, None] * torch.exp(torch.where(
        mask(later), Lp[:, :, None] - Lb, float("-inf")))
    K = k[:, :, None] * torch.exp(torch.where(
        mask(~later), Lb - L[:, :, None], float("-inf")))
    A = product("bjqthn,bjqshn->bjtsh", R, K * mask(last))
    Y = product("bjtsh,bjqshn->bjqthn", Bd, K)
    Z = product("bjtsh,bjqthn->bjqshn", Bd, R)
    drp = (torch.exp(torch.where(mask(rows), Lp[:, :, None] - Lb,
                                 float("-inf"))) * Y).sum(2)
    dkp = (torch.exp(torch.where(mask(last), Lb - L[:, :, None],
                                 float("-inf"))) * Z).sum(2)
    return A, drp, dkp


def diag_terms(r, k, L, Lp, Bd):
    """The parts of A, dr' and dk' between steps s < t of one sub-chunk,
    exact: D[t,s] = exp(Lprev_t - L_s) per (t, s, n), as the kernel takes
    them on CUDA cores (shapes as ``subchunk_terms``).  Returns (A (B,nc,
    c,c,H), zero outside the diagonal blocks, dr', dk' (B,nc,c,H,N))."""
    Bn, nc, c, H, N = r.shape
    ns = c // SUB
    shape = (Bn, nc, ns, SUB, H, N)
    r_, k_, L_, Lp_ = (t.reshape(shape) for t in (r, k, L, Lp))
    tril = torch.ones((SUB, SUB), dtype=torch.bool,
                      device=r.device).tril(-1)[:, :, None, None]
    D = torch.exp(torch.where(tril, Lp_[:, :, :, :, None]
                              - L_[:, :, :, None], float("-inf")))
    Bdd = Bd.reshape(Bn, nc, ns, SUB, ns, SUB, H).diagonal(
        dim1=2, dim2=4).movedim(-1, 2)                     # (B,nc,ns,t,s,H)
    Ad = (r_[:, :, :, :, None] * D * k_[:, :, :, None]).sum(-1)
    drp = (Bdd[..., None] * D * k_[:, :, :, None]).sum(4)
    dkp = (Bdd[..., None] * D * r_[:, :, :, :, None]).sum(3)
    A = r.new_zeros((Bn, nc, ns, SUB, ns, SUB, H))
    for i in range(ns):
        A[:, :, i, :, i] = Ad[:, :, i]
    return (A.reshape(Bn, nc, c, c, H), drp.reshape(Bn, nc, c, H, N),
            dkp.reshape(Bn, nc, c, H, N))


def wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT=None,
                   product=torch.einsum):
    """The gradients (dr, dk, dv, dlogw (B,T,H,N), du (H,N), ds0 (B,H,N,N))
    of ``wkv6_plain``'s (y, s_T) at these inputs, given dy (B,T,H,N) and
    dsT (B,H,N,N) (None: zero), all float32.

    In the backward kernels' factoring: two scans over the chunk
    boundaries, then every chunk's terms at once.  The scans give the state
    at each chunk's start (``chunk_states``) and the adjoint of the state
    at each chunk's end (``chunk_adjoints``: dS_{t-1} = diag(w_t) dS_t +
    r_t dy_t^T from dS_T = dsT, a chunk at a time).  Inside a chunk, with
    S its start state, S' its end state, G the adjoint arriving at its
    end, D[t,s] = exp(Lprev_t - L_s) (s < t), A the forward's matrix (its
    diagonal the u bonus) and Bd[t,s] = dy_t . v_s:
        dv_s  = sum_{t>=s} A[t,s] dy_t + (k_s o exp(L_c - L_s))^T G
        dr'_t = sum_{s<t} Bd[t,s] D[t,s] o k_s + exp(Lprev_t) o S dy_t
        dk'_s = sum_{t>s} Bd[t,s] D[t,s] o r_t + exp(L_c - L_s) o G v_s
    where A, dr' and dk' between sub-chunks of SUB steps take D as a
    product of two factors (``subchunk_terms``) and within one exactly
    (``diag_terms``).  dr and dk add the u bonus's parts, u o k_t (v_t.dy_t)
    and r_t o u (v_t.dy_t); du sums r o k (v.dy) over each chunk, then the
    chunks in order.  The log decay's gradient needs no N x N product per
    step: dlogw_t = dS_t . (S_t - k_t v_t^T) row by row, and stepping that
    back through the chunk gives
        dlogw_t = sum_m S'[n,m] G[n,m]
                  + sum_{t < tau} r_tau o dr'_tau - sum_{t <= tau} k_tau o dk'_tau
    (tau up to the chunk's end), reverse cumulative sums anchored at every
    chunk.  Under strong decay the terms are far larger than dlogw, which
    costs precision there (scripts/recurrent_bwd_precision.py).  Every
    exponent is <= 0.  Steps past T are k = v = 0, logw = 0, dy = 0.
    ``product`` takes every matrix product the kernels run on tensor cores
    (an einsum; scripts/recurrent_bwd_precision.py passes one that rounds
    as they do)."""
    B, T, H, N = r.shape
    c = CHUNK
    Tp = -(-T // c) * c
    nc = Tp // c
    pad = (0, 0, 0, 0, 0, Tp - T)
    dy = torch.zeros_like(r, dtype=torch.float32) if dy is None else dy
    r, k, v, logw, dy = (F.pad(t.float(), pad) for t in (r, k, v, logw, dy))
    u = u.float()
    dsT = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
           if dsT is None else dsT.float())
    # the two boundary scans, then (B, nc, ...) views of every chunk
    states = chunk_states(k, v, logw, s0, product)
    adj = chunk_adjoints(r, logw, dy, dsT, product)
    S, S1 = (states[:, :, a:a + nc].transpose(1, 2) for a in (0, 1))
    G = adj[:, :, 1:].transpose(1, 2)                     # (B,nc,H,N,N)
    r, k, v, logw, dy = (t.reshape(B, nc, c, H, N)
                         for t in (r, k, v, logw, dy))
    L = torch.cumsum(logw, dim=2)
    Lp = F.pad(L[:, :, :-1], (0, 0, 0, 0, 1, 0))          # exactly L_{t-1}
    Lc = L[:, :, -1:]                                     # (B,nc,1,H,N)
    Bd = product("bjthm,bjshm->bjtsh", dy, v)
    idx = torch.arange(c, device=r.device)
    vdy = Bd[:, :, idx, idx][..., None]                   # (B,nc,c,H,1)
    A_off, drp_off, dkp_off = subchunk_terms(r, k, L, Lp, Bd, product)
    A_d, drp_d, dkp_d = diag_terms(r, k, L, Lp, Bd)
    A = A_off + A_d
    A[:, :, idx, idx] += (r * u * k).sum(-1)              # the bonus
    back = torch.exp(Lc - L)
    dv = (product("bjtsh,bjthm->bjshm", A, dy)
          + product("bjshn,bjhnm->bjshm", k * back, G))
    drp = (drp_off + drp_d
           + torch.exp(Lp) * product("bjhnm,bjthm->bjthn", S, dy))
    dkp = dkp_off + dkp_d + back * product("bjhnm,bjshm->bjshn", G, v)
    dr = drp + u * k * vdy
    dk = dkp + r * u * vdy
    du = (r * k * vdy).sum(2).reshape(B * nc, H, N).sum(0)
    anchor = (S1 * G).sum(-1)[:, :, None]                 # (B,nc,1,H,N)
    rd_incl = (r * drp).flip(2).cumsum(2).flip(2)         # sum over tau >= t
    kk_incl = (k * dkp).flip(2).cumsum(2).flip(2)
    rd_excl = F.pad(rd_incl[:, :, 1:], (0, 0, 0, 0, 0, 1))
    dlogw = anchor + rd_excl - kk_incl
    return (*(t.reshape(B, Tp, H, N)[:, :T] for t in (dr, dk, dv, dlogw)),
            du, adj[:, :, 0])

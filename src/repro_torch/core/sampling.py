"""Per-request token sampling: temperature / top-k / top-p with seeds.

The port of ``repro/core/sampling.py``.  ``SamplingParams`` is the
per-request contract (validated at construction), ``TokenSampler`` the
numpy host reference, and ``sample_tokens`` the vectorised device sampler
over per-row parameter tensors (temperature / top_k / top_p / base rng key
/ token counter), so only the sampled ids, ``(batch,)`` int32, need to
reach the host per decode tick.  The RNG contract is the JAX package's,
reproduced bit for bit by ``repro_torch.core.rng``:

    token j of a request  ~  categorical(fold_in(PRNGKey(seed), j),
                                         filtered logits of step j)

One difference of mechanism: JAX picks the regime (all greedy, plain
categorical, filtered) with ``lax.cond`` on device values.  Here the regime
comes from the host copies of the sampling arrays (``sampling_regime``),
which the engine builds in numpy anyway; branching on a device value
would cost a host sync on every tick.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rng


class SamplingError(ValueError):
    """Malformed sampling parameters (client error, maps to HTTP 400)."""


@dataclass(frozen=True)
class SamplingParams:
    """One request's decode configuration.

    temperature == 0 selects greedy decoding (the default); ``top_k``/
    ``top_p`` restrict the candidate set before renormalizing; ``seed``
    makes a stochastic request reproducible; ``stop`` is a set of extra
    stop-token ids that end generation like ``eos_id`` does (the stop
    token is kept in the output, mirroring eos handling).
    """

    temperature: float = 0.0
    top_k: int = 0                      # 0 disables the top-k filter
    top_p: float = 1.0                  # 1.0 disables the nucleus filter
    seed: Optional[int] = None
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    stop: Tuple[int, ...] = ()
    speculation: bool = True            # per-request speculative-decode opt-out

    def __post_init__(self):
        self.validate()

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> "SamplingParams":
        try:
            temp_ok = np.isfinite(self.temperature)
        except TypeError:
            temp_ok = False
        if not temp_ok or self.temperature < 0:
            raise SamplingError(
                f"'temperature' must be a finite float >= 0, "
                f"got {self.temperature!r}")
        if not isinstance(self.top_k, (int, np.integer)) or self.top_k < 0:
            raise SamplingError(f"'top_k' must be >= 0, got {self.top_k!r}")
        try:
            top_p_ok = 0.0 < self.top_p <= 1.0
        except TypeError:
            top_p_ok = False
        if not top_p_ok:
            raise SamplingError(
                f"'top_p' must be in (0, 1], got {self.top_p!r}")
        if not isinstance(self.max_new_tokens, (int, np.integer)) \
                or self.max_new_tokens < 1:
            raise SamplingError(
                f"'max_new_tokens' must be >= 1, got {self.max_new_tokens!r}")
        if not isinstance(self.stop, (list, tuple)) or not all(
                isinstance(t, (int, np.integer)) for t in self.stop):
            raise SamplingError("'stop' must be a list of token ids, "
                                f"got {self.stop!r}")
        return self

    @classmethod
    def from_request(cls, req: Dict[str, Any], *,
                     default_max_new_tokens: int = 16) -> "SamplingParams":
        """Build + validate from a JSON request body (raises SamplingError
        with a client-readable message on malformed fields)."""
        def _num(key, default, cast):
            val = req.get(key, default)
            if val is None:
                return default
            try:
                return cast(val)
            except (TypeError, ValueError):
                raise SamplingError(
                    f"{key!r} must be a {cast.__name__}, "
                    f"got {val!r}") from None

        stop = req.get("stop", ())
        if stop is None:
            stop = ()
        if not isinstance(stop, (list, tuple)) or \
                not all(isinstance(t, int) for t in stop):
            raise SamplingError("'stop' must be a list of token ids")
        seed = req.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise SamplingError(f"'seed' must be an integer, got {seed!r}")
        eos = req.get("eos_id")
        if eos is not None and not isinstance(eos, int):
            raise SamplingError(f"'eos_id' must be an integer, got {eos!r}")
        speculation = req.get("speculation", True)
        if not isinstance(speculation, bool):
            raise SamplingError(
                f"'speculation' must be a boolean, got {speculation!r}")
        return cls(
            temperature=_num("temperature", 0.0, float),
            top_k=_num("top_k", 0, int),
            top_p=_num("top_p", 1.0, float),
            seed=seed,
            max_new_tokens=_num("max_new_tokens",
                                default_max_new_tokens, int),
            eos_id=eos,
            stop=tuple(stop),
            speculation=speculation,
        ).validate()

    def for_row(self, row: int) -> "SamplingParams":
        """The row-th prompt's params in a multi-prompt request: seeded
        requests give each row its own reproducible stream (seed + row)."""
        if self.seed is None or row == 0:
            return self
        return replace(self, seed=self.seed + row)

    def sampler(self) -> "TokenSampler":
        return TokenSampler(self)

    def resolve_seed(self) -> int:
        """Concrete base seed for the device rng: the request's seed when
        given, fresh entropy otherwise."""
        return self.seed if self.seed is not None else secrets.randbits(31)

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"temperature": self.temperature,
                               "max_new_tokens": self.max_new_tokens}
        if self.top_k:
            out["top_k"] = self.top_k
        if self.top_p < 1.0:
            out["top_p"] = self.top_p
        if self.seed is not None:
            out["seed"] = self.seed
        if self.eos_id is not None:
            out["eos_id"] = self.eos_id
        if self.stop:
            out["stop"] = list(self.stop)
        if not self.speculation:
            out["speculation"] = False
        return out


@dataclass
class TokenSampler:
    """Per-slot sampling state: params + this request's own numpy rng."""

    params: SamplingParams
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.params.seed)

    def sample(self, logits_row: np.ndarray) -> int:
        """Next token id from one row of decode logits (host numpy)."""
        p = self.params
        row = np.asarray(logits_row, np.float64).reshape(-1)
        if p.greedy:
            return int(row.argmax())
        row = row / p.temperature
        if p.top_k and p.top_k < row.size:
            kth = np.partition(row, -p.top_k)[-p.top_k]
            row = np.where(row < kth, -np.inf, row)
        row = row - row.max()
        probs = np.exp(row)
        probs /= probs.sum()
        if p.top_p < 1.0:
            # grow a top-k candidate set until it holds the target mass,
            # then sort only the candidates
            V = probs.size
            k = min(64, V)
            while True:
                cand = np.argpartition(probs, V - k)[V - k:]
                if k == V or probs[cand].sum() >= p.top_p:
                    break
                k = min(V, 2 * k)
            order = cand[np.argsort(probs[cand])[::-1]]
            csum = np.cumsum(probs[order])
            # smallest prefix whose mass reaches top_p (>= keeps >=1 token)
            cut = int(np.searchsorted(csum, p.top_p)) + 1
            keep = order[:cut]
            mask = np.zeros_like(probs)
            mask[keep] = probs[keep]
            probs = mask / mask.sum()
        return int(self.rng.choice(probs.size, p=probs))

    def is_stop(self, token: int) -> bool:
        p = self.params
        return ((p.eos_id is not None and token == p.eos_id)
                or token in p.stop)


def samplers_for(params: SamplingParams, n: int) -> List[TokenSampler]:
    """One independent sampler per row of an n-prompt request."""
    return [params.for_row(i).sampler() for i in range(n)]


# --- device sampling ----------------------------------------------------------
#
# Per-row sampling state, one row per decode slot:
#
#   temperature (B,) f32   <= 0 selects greedy (also the empty-slot value)
#   top_k       (B,) i32   0 disables
#   top_p       (B,) f32   1.0 disables
#   key         (B,2)      raw PRNGKey(seed) of the row's request (32-bit
#                          words, held as int64 tensors on the device)
#
# plus the token counter ctr (B,) i32 == the index of the token being
# sampled.


def base_key(seed: int) -> np.ndarray:
    """The request's raw base rng key as host uint32[2] (slot-insertable)."""
    return rng.base_key(seed)


_BISECT_ITERS = 32          # float32 threshold bisection convergence


def _filter_top_k(scaled, top_k):
    """Mask each row below its top_k-th largest value, found by threshold
    bisection (count(row >= t) is monotone in t) as the JAX package does.
    Ties at the kth value are kept, matching the host reference."""
    V = scaled.shape[-1]
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, V),
                    torch.full_like(top_k, V))
    lo = scaled.amin(dim=-1)                 # count(>= lo) == V >= k
    hi = scaled.amax(dim=-1)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = (scaled >= mid[:, None]).sum(dim=-1)
        ok = cnt >= k                        # invariant: count(>= lo) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(scaled < lo[:, None], -torch.inf, scaled)


def _filter_top_p(masked, top_p):
    """Nucleus mask: keep each row's smallest set of highest-probability
    tokens reaching mass top_p, cutoff bisected on the probability;
    boundary-probability ties are kept."""
    probs = torch.softmax(masked, dim=-1)
    B = masked.shape[0]
    lo = torch.zeros((B,), dtype=masked.dtype, device=masked.device)
    hi = torch.ones((B,), dtype=masked.dtype, device=masked.device)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid[:, None], probs, 0.0).sum(dim=-1)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(probs < lo[:, None], -torch.inf, masked)


def sampling_regime(temperature, top_k, top_p, vocab: int) -> str:
    """Which of ``sample_tokens``' three programs a batch needs, from host
    arrays: "greedy" (every row), "plain" (categorical, no filter active
    in any row) or "filtered" (the bisection filters first)."""
    temperature, top_k, top_p = (np.asarray(a) for a in
                                 (temperature, top_k, top_p))
    if np.all(temperature <= 0.0):
        return "greedy"
    if np.all((top_k <= 0) | (top_k >= vocab)) and np.all(top_p >= 1.0):
        return "plain"
    return "filtered"


def sample_tokens(logits, temperature, top_k, top_p, key, ctr, *,
                  regime: Optional[str] = None):
    """Vectorised sampling: (B, V) logits + per-row params -> (B,) int32
    ids, the JAX package's function.  ``regime`` comes from
    ``sampling_regime`` over the host copies of the parameters; without it
    the parameters are read back from the device to choose one.  Greedy
    rows inside a stochastic batch take their argmax."""
    logits = logits.float()
    V = logits.shape[-1]
    if regime is None:
        regime = sampling_regime(*(torch.as_tensor(a).cpu().numpy()
                                   for a in (temperature, top_k, top_p)), V)
    argmax = torch.argmax(logits, dim=-1).to(torch.int32)
    if regime == "greedy":
        return argmax
    dev = logits.device
    temperature = temperature.to(dev, torch.float32)
    top_k = top_k.to(dev, torch.int32)
    top_p = top_p.to(dev, torch.float32)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if regime == "filtered":
        masked = _filter_top_p(_filter_top_k(scaled, top_k), top_p)
    elif regime == "plain":
        masked = scaled
    else:
        raise ValueError(f"unknown sampling regime {regime!r}")
    keys = rng.fold_in(rng.as_key(key, dev), ctr.to(dev))
    sampled = rng.categorical(keys, masked).to(torch.int32)
    return torch.where(temperature <= 0.0, argmax, sampled)


# --- speculative accept/reject ------------------------------------------------


def speculative_accept(logits, drafts, temperature, top_k, top_p, key, ctr,
                       *, regime: Optional[str] = None):
    """Batched accept/reject over one verify window.

    ``logits`` (B, W, V) are the target's verify-forward logits: row
    ``[b, i]`` is the distribution for output token ``ctr[b] + i``.
    ``drafts`` (B, W-1) are the draft's proposals for output tokens
    ``ctr .. ctr+W-2``.  Every row's token j is drawn with the sequential
    contract, ``categorical(fold_in(key, ctr+j), filtered logits)``, by ONE
    flattened ``sample_tokens`` call (a row's params repeated W times keep
    the batch's regime, so the draws are bitwise the sequential ones).  A
    draft survives iff it equals that draw; the first mismatch's draw is
    the correction token.  ``regime`` is the host-chosen regime of the
    un-repeated batch, as for ``sample_tokens``.

    Returns (draws (B, W) int32 — each row's first ``counts[b]`` are the
    emitted tokens — and counts (B,) int32 in [1, W])."""
    B, W, V = logits.shape

    def rep(a):
        return torch.repeat_interleave(a, W, dim=0)

    ctr = ctr.to(logits.device)
    ctr_flat = (ctr[:, None] + torch.arange(W, device=ctr.device,
                                            dtype=ctr.dtype)[None, :])
    draws = sample_tokens(logits.reshape(B * W, V), rep(temperature),
                          rep(top_k), rep(top_p), rep(key),
                          ctr_flat.reshape(-1),
                          regime=regime).reshape(B, W)
    # leading run of draft == draw matches, +1 for the correction/bonus
    hits = (draws[:, :W - 1] == drafts).to(torch.int32)
    counts = torch.cumprod(hits, dim=1).sum(dim=1) + 1
    return draws, counts.to(torch.int32)

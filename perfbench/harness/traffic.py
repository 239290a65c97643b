"""The one traffic generator.  A mix is data (``traffic/<name>.json``);
this module turns it and a seed into requests.

Keys of a mix:
  ``request``   the route's module under ``requests/`` (``infer``);
  ``loop``      ``closed`` (``clients`` callers, each sending its next
                request when the last one is answered) or ``open``
                (``rate_per_s`` arrivals on a schedule that waits for no
                reply, ``max_in_flight`` connections to send them on);
  ``rows``      [[rows, share], ...]: rows per request;
  ``seq_len``   tokens per row, or [[tokens, share], ...];
  ``policy``    the ensemble policy the requests ask for.

Every seed gets the same work: the sizes are the mix's exact shares and
the open loop's gaps the same quantiles of an exponential distribution,
each put in an order drawn from the seed; only the order and the token ids
change with the seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# streams of the seed, kept apart so that adding one moves no other
SIZES, GAPS, TOKENS, WARM = 1, 2, 3, 4
CLOSED_BLOCK = 120


def seed_words(seed: int) -> List[int]:
    """A whole-number seed of any size or sign as SeedSequence words."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed) + list(stream))


def choices(spec) -> List[Tuple[int, float]]:
    """``[[value, share], ...]`` or a single value, as (value, share)."""
    if isinstance(spec, (int, float)):
        return [(int(spec), 1.0)]
    out = [(int(v), float(w)) for v, w in spec]
    if not out or any(w <= 0 for _, w in out):
        raise ValueError(f"bad choices {spec!r}")
    return out


def exact_counts(weights: Sequence[float], n: int) -> List[int]:
    """``n`` split in proportion to ``weights`` (largest remainder)."""
    total = float(sum(weights))
    raw = [n * w / total for w in weights]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: (counts[i] - raw[i], i))
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


@dataclass(frozen=True)
class Request:
    """One request of a run: who sends it, its size, and for the open
    loop when it is due (seconds after the window opens)."""

    index: int
    client: int
    rows: int
    seq_len: int
    due_s: Optional[float] = None


class Mix:
    """A traffic mix and a seed."""

    def __init__(self, spec: Dict[str, Any], seed: int, vocab_size: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.loop = spec["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"loop must be 'closed' or 'open', "
                             f"not {self.loop!r}")
        rows = choices(spec["rows"])
        seqs = choices(spec["seq_len"])
        self.sizes_choices = [((r, s), wr * ws) for r, wr in rows
                              for s, ws in seqs]
        self.clients = (int(spec["clients"]) if self.loop == "closed"
                        else int(spec.get("max_in_flight", 64)))
        self._closed_sizes: Dict[int, List[Tuple[int, int]]] = {}

    # --- sizes ---------------------------------------------------------------

    def _sizes(self, n: int, *stream: int) -> List[Tuple[int, int]]:
        counts = exact_counts([w for _, w in self.sizes_choices], n)
        sizes = [v for (v, _), c in zip(self.sizes_choices, counts)
                 for _ in range(c)]
        order = rng(self.seed, SIZES, *stream).permutation(n)
        return [sizes[i] for i in order]

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        """Every (rows, seq_len) a request of this mix can have."""
        return [v for v, _ in self.sizes_choices]

    # --- the closed loop -----------------------------------------------------

    def closed_request(self, client: int, k: int) -> Request:
        """Client ``client``'s ``k``-th request: sizes in blocks of the
        mix's exact shares, each block in its own order."""
        block, i = divmod(k, CLOSED_BLOCK)
        key = client * 1_000_003 + block
        if key not in self._closed_sizes:
            self._closed_sizes[key] = self._sizes(CLOSED_BLOCK, client, block)
        rows, seq = self._closed_sizes[key][i]
        return Request(k, client, rows, seq)

    # --- the open loop -------------------------------------------------------

    def schedule(self, seconds: float) -> List[Request]:
        """The open loop's requests over a window of ``seconds``: the
        rate's count of arrivals, their gaps the quantiles of the
        exponential distribution in an order drawn from the seed, scaled
        so that they span the window."""
        rate = float(self.spec["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        q = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-q)[rng(self.seed, GAPS).permutation(n)]
        starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        due = starts * (seconds / gaps.sum())
        sizes = self._sizes(n, 0)
        return [Request(k, 0, rows, seq, float(d))
                for k, ((rows, seq), d) in enumerate(zip(sizes, due))]

    # --- token ids -----------------------------------------------------------

    def tokens(self, req: Request) -> np.ndarray:
        """The request's token ids, uniform over the vocabulary."""
        g = rng(self.seed, TOKENS, req.client, req.index)
        return g.integers(0, self.vocab_size, (req.rows, req.seq_len),
                          dtype=np.int32)

    def warm_tokens(self, rows: int, seq_len: int, k: int) -> np.ndarray:
        g = rng(self.seed, WARM, rows, seq_len, k)
        return g.integers(0, self.vocab_size, (rows, seq_len),
                          dtype=np.int32)

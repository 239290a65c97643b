"""InferenceEngine: bucketed prefill + autoregressive decode with on-device
sampling; PagedInferenceEngine: the same over a block-paged KV pool.

The port of ``repro/core/engine.py``, with ``SpeculativeEngine``, the
draft-propose / target-verify pair.  One engine serves one model.  It
owns the decode state, buckets prompt lengths and batch sizes as the JAX
engine does (so the kernels' launch shapes come from a bounded set), and
keeps the decode data path on the device:
``decode_sample`` runs the model's decode step and samples the next ids
there, so per tick only the ``(batch,)`` int32 ids cross to the host.

The flags that shape a decode state (``STATE_FLAGS`` of
``repro_torch.opt``: the e4m3 cache, the ring cache) are read when an
engine is built, and every state it allocates later is made under them,
whichever thread asks (a scheduler's service thread sees no flag set in
its builder's thread).

Where the JAX engine jits and donates, this one runs eagerly under
``torch.no_grad`` and the model writes each tick's K/V into the state's
cache in place; a state passed to ``prefill`` or ``decode`` must not be
used again afterwards except through the returned one.  The sampling
regime (greedy / plain / filtered) is chosen on the host from the numpy
copies of the per-row parameters, carried in ``samp["regime"]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import opt
from repro_torch.core.batching import BucketSpec, pad_sequences
from repro_torch.core.kv_pager import pages_for_budget
from repro_torch.core.sampling import (SamplingParams, base_key,
                                       sample_tokens, samplers_for,
                                       sampling_regime, speculative_accept)
from repro_torch.models import paged, transformer
from repro_torch.models.attention import cache_dtype, raw, to_cache
from repro_torch.models.build import Model


@dataclass
class GenerationResult:
    tokens: List[List[int]]            # new tokens per row
    prompt_lengths: List[int]
    steps: int
    finish_reasons: Optional[List[Optional[str]]] = None


# the flags that decide a decode state's layout and dtype
STATE_FLAGS = ("kv_cache_f8", "ring_cache")


class InferenceEngine:
    def __init__(self, model: Model, params, *, max_len: int = 2048,
                 max_batch: int = 8, window: Optional[int] = None):
        self.state_flags = {k: opt.enabled(k) for k in STATE_FLAGS}
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_len = max_len
        self.window = window
        self.batch_buckets = BucketSpec.pow2(max_batch)
        self.seq_buckets = BucketSpec.pow2(max_len, min_size=16)
        # forward-call accounting (batched prefill shows up as fewer
        # prefill calls than admitted requests)
        self.prefill_calls = 0
        self.decode_calls = 0
        self._kw = {} if window is None else {"window": window}
        self._state_axes = None

    # --- API -----------------------------------------------------------------

    def new_state(self, batch: int, device=None):
        with opt.flags(**self.state_flags):
            return self.model.init_state(batch, self.max_len,
                                         device=device or self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], state):
        self.prefill_calls += 1
        return self.model.prefill(self.params, batch, state, **self._kw)

    @torch.no_grad()
    def decode(self, token, state):
        self.decode_calls += 1
        return self._decode_step(token, state)

    def _decode_step(self, token, state):
        """The model's one-token step on this engine's state layout."""
        return self.model.decode(self.params, token, state, **self._kw)

    @torch.no_grad()
    def decode_sample(self, token, state, samp: Dict[str, Any], ctr):
        """One decode tick: model decode step + on-device sampling.
        ``samp`` holds the per-row tensors (temperature/top_k/top_p/key)
        and the host-chosen "regime", ``ctr`` the per-row token counters.
        Returns ``(token_ids (B,) int32 device tensor, new_state, ctr+1)``;
        the ids are the only thing a caller needs to pull to the host."""
        self.decode_calls += 1
        logits, state = self._decode_step(token, state)
        toks = self.sample(logits, samp, ctr)
        return toks, state, ctr + 1

    @torch.no_grad()
    def sample(self, logits, samp: Dict[str, Any], ctr):
        """On-device sampling of standalone logits (the prefill first-token
        path); same per-row contract as ``decode_sample``."""
        return sample_tokens(logits, samp["temperature"], samp["top_k"],
                             samp["top_p"], samp["key"], ctr,
                             regime=samp.get("regime"))

    def decode_cache_size(self) -> Optional[int]:
        """Compiled-variant count of the decode step: None, since eager
        PyTorch compiles nothing to introspect (the JAX contract's value
        when a build has no cache introspection)."""
        return None

    @torch.no_grad()
    def insert_rows(self, pool_state, group_state, src_rows, write_mask):
        """Slot scatter: copy selected rows of a freshly prefilled GROUP
        state into selected slots of a pooled decode state.  Slot b takes
        group row ``src_rows[b]`` iff ``write_mask[b]``.  Returns a new
        state; the pool's tensors are left as they were.  An e4m3 leaf
        moves as bytes."""
        axes = self.state_batch_axes()
        dev = self.device
        src_rows = torch.as_tensor(src_rows, device=dev).long()
        write_mask = torch.as_tensor(write_mask, device=dev).bool()

        def one(pool, sub, axis):
            if axis is None:
                return pool
            pool_m = raw(pool).movedim(axis, 0)
            picked = raw(to_cache(sub, pool.dtype)).movedim(
                axis, 0).index_select(0, src_rows)
            mask = write_mask.reshape((-1,) + (1,) * (pool_m.ndim - 1))
            out = torch.where(mask, picked, pool_m)
            return out.movedim(0, axis).view(pool.dtype)

        return _map_state(one, pool_state, group_state, axes)

    def state_batch_axes(self):
        """Per-leaf batch axis of the decode state, found by comparing the
        state's shapes at two batch sizes on the meta device (nothing is
        allocated)."""
        if self._state_axes is None:
            s2, s3 = (self.new_state(n, device="meta") for n in (2, 3))
            self._state_axes = _map_state(
                lambda a, b: next((i for i, (x, y) in
                                   enumerate(zip(a.shape, b.shape))
                                   if x != y), None), s2, s3)
        return self._state_axes

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 32, eos_id: Optional[int] = None,
                 extras: Optional[Dict[str, Any]] = None,
                 sampling: Optional[SamplingParams] = None,
                 device_sampling: bool = True) -> GenerationResult:
        """Generation for a variable-size batch of variable-length prompts
        (greedy by default; ``sampling`` selects per-row temperature /
        top-k / top-p decoding).  Batch and prompt length are bucketed;
        rows beyond the real batch are masked out of the result.

        With ``device_sampling`` (default) every step samples on the
        device: row i of a seeded request draws token j with
        ``fold_in(PRNGKey(seed + i), j)``, the JAX engine's stream.
        ``device_sampling=False`` keeps the numpy ``TokenSampler``
        reference path."""
        if sampling is None:
            sampling = SamplingParams(max_new_tokens=max_new_tokens,
                                      eos_id=eos_id)
        n = len(prompts)
        B = self.batch_buckets.bucket_for(n)
        tokens, lengths = pad_sequences(prompts, self.seq_buckets)
        tokens = np.asarray(pad_batch_rows(tokens, B))
        lengths = np.asarray(pad_batch_rows(lengths, B, fill=1))
        state = self.new_state(B)
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "lengths": torch.from_numpy(lengths.astype(np.int32)).to(
                     self.device)}
        if extras:
            batch.update({k: _pad_rows(v, B, self.device)
                          for k, v in extras.items()})
        logits, state = self.prefill(batch, state)
        if device_sampling:
            return self._generate_device(prompts, sampling, logits, state)
        return self._generate_host(prompts, sampling, logits, state)

    def _generate_device(self, prompts, sampling: SamplingParams,
                         logits, state) -> GenerationResult:
        """Device-resident decode loop: per step, only (B,) token ids
        cross to the host."""
        n = len(prompts)
        B = logits.shape[0]
        row_params = [sampling.for_row(i) for i in range(n)]
        samplers = [p.sampler() for p in row_params]       # is_stop only
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        keys = np.zeros((B, 2), np.int64)
        for i, p in enumerate(row_params):
            temps[i] = p.temperature
            top_ks[i] = p.top_k
            top_ps[i] = p.top_p
            keys[i] = base_key(p.resolve_seed())
        dev = self.device
        samp = {"temperature": torch.from_numpy(temps).to(dev),
                "top_k": torch.from_numpy(top_ks).to(dev),
                "top_p": torch.from_numpy(top_ps).to(dev),
                "key": torch.from_numpy(keys).to(dev),
                "regime": sampling_regime(temps, top_ks, top_ps,
                                          logits.shape[-1])}
        out: List[List[int]] = [[] for _ in range(n)]
        reasons: List[Optional[str]] = [None] * n
        done = np.zeros((n,), bool)
        steps = 0
        # ctr is uniform across rows: a live row has produced exactly
        # `step` tokens when token `step` is sampled (done rows ignore it)
        ctr = torch.zeros((B,), dtype=torch.int32, device=dev)
        tok_dev = self.sample(logits, samp, ctr)
        ctr = ctr + 1
        for _ in range(sampling.max_new_tokens):
            host = tok_dev.cpu().numpy()                   # (B,) int32
            for i in range(n):
                if done[i]:
                    continue
                t = int(host[i])
                out[i].append(t)
                if samplers[i].is_stop(t):
                    done[i] = True
                    reasons[i] = ("eos" if sampling.eos_id is not None
                                  and t == sampling.eos_id else "stop")
                elif len(out[i]) >= sampling.max_new_tokens:
                    done[i] = True
                    reasons[i] = "length"
            steps += 1
            if done.all():
                break
            tok_dev, state, ctr = self.decode_sample(tok_dev, state,
                                                     samp, ctr)
        return GenerationResult(tokens=out,
                                prompt_lengths=[len(p) for p in prompts],
                                steps=steps, finish_reasons=reasons)

    def _generate_host(self, prompts, sampling: SamplingParams,
                       logits, state) -> GenerationResult:
        """Reference decode loop: numpy TokenSampler on host logits."""
        n = len(prompts)
        B = logits.shape[0]
        samplers = samplers_for(sampling, n)
        out: List[List[int]] = [[] for _ in range(n)]
        reasons: List[Optional[str]] = [None] * n
        done = np.zeros((n,), bool)
        steps = 0
        next_host = np.zeros((B,), np.int32)
        for _ in range(sampling.max_new_tokens):
            if sampling.greedy:
                # argmax on the device: only B ints cross to the host
                host_logits = None
                greedy = torch.argmax(logits, -1).to(torch.int32).cpu() \
                    .numpy()
            else:
                host_logits = logits.float().cpu().numpy()     # (B, V)
            for i in range(n):
                if done[i]:
                    continue
                t = (int(greedy[i]) if host_logits is None
                     else samplers[i].sample(host_logits[i]))
                out[i].append(t)
                next_host[i] = t
                if samplers[i].is_stop(t):
                    done[i] = True
                    reasons[i] = ("eos" if sampling.eos_id is not None
                                  and t == sampling.eos_id else "stop")
                elif len(out[i]) >= sampling.max_new_tokens:
                    done[i] = True
                    reasons[i] = "length"
            steps += 1
            if done.all():
                break
            logits, state = self.decode(
                torch.from_numpy(next_host).to(self.device), state)
        return GenerationResult(tokens=out,
                                prompt_lengths=[len(p) for p in prompts],
                                steps=steps, finish_reasons=reasons)


class PagedInferenceEngine(InferenceEngine):
    """InferenceEngine whose decode state is a block-paged KV pool.

    Same public decode contract as the dense engine — ``decode_sample`` /
    ``sample`` / ``decode_cache_size`` are inherited, so the scheduler's
    decode tick is the same — but the state carries a shared
    ``(layers, num_pages, page_size, K, hd)`` page pool plus a per-slot
    ``(num_slots, max_pages_per_seq)`` page table instead of per-slot
    worst-case caches.  Page bookkeeping (allocation, refcounts, prefix
    sharing) lives host-side in the scheduler's ``KVPager``; this class
    owns only the device programs.  Decode attends through K3
    (``paged_decode_attention``) on a CUDA state.

    Prefill is context-aware: ``paged_prefill`` runs the SUFFIX of each
    prompt (what its shared prefix doesn't cover) and commits the new K/V
    straight into freshly allocated pool pages, in place — there is no
    per-group cache to scatter with ``insert_rows`` afterwards."""

    def __init__(self, model: Model, params, *, max_len: int = 2048,
                 max_batch: int = 8, window: Optional[int] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None):
        cfg = model.config
        if not paged.supports_paging(cfg):
            raise ValueError(f"{cfg.name}: no paged KV path for family "
                             f"{cfg.family}/{cfg.attn_kind}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        super().__init__(model, params, max_len=max_len, max_batch=max_batch,
                         window=window)
        self.paged = True
        self.page_size = page_size
        self.max_pages_per_seq = max_len // page_size
        self.page_bytes = page_kv_bytes(cfg, page_size)
        if num_pages is None:
            if hbm_budget_bytes is not None:
                num_pages = pages_for_budget(hbm_budget_bytes,
                                             self.page_bytes)
            else:
                # dense-equivalent worst case + the reserved dump page
                num_pages = max_batch * self.max_pages_per_seq + 1
        if num_pages - 1 < self.max_pages_per_seq:
            raise ValueError(
                f"{num_pages} pages cannot hold even one max-length "
                f"sequence ({self.max_pages_per_seq} pages)")
        self.num_pages = num_pages
        # context-page-count buckets for the shared-prefix prefill variants
        self.ctx_buckets = BucketSpec.pow2(self.max_pages_per_seq,
                                           min_size=1)
        self._pkw: Dict[str, Any] = {"page_size": page_size, **self._kw}

    def ctx_bucket_for(self, n_ctx_pages: int) -> int:
        """Bucketed context-page count (0 stays 0: the no-sharing prefill
        variant is exactly the dense computation)."""
        if n_ctx_pages == 0:
            return 0
        return self.ctx_buckets.bucket_for(n_ctx_pages)

    def new_state(self, batch: int, device=None):
        with opt.flags(**self.state_flags):
            return paged.init_paged_state(self.model.config, batch,
                                          self.num_pages, self.page_size,
                                          self.max_pages_per_seq,
                                          device=device or self.device)

    @torch.no_grad()
    def paged_prefill(self, state, tokens, lengths, ctx_table, ctx_lens,
                      dest_table):
        """Suffix prefill into pool pages.  ``tokens``/``lengths`` are the
        bucketed per-row suffixes, ``ctx_table`` the shared prefix pages
        each row attends to, ``dest_table`` the pages the new K/V lands in.
        Returns ``(first-token logits, new state)`` — the pool is updated
        in place; the table/length tensors pass through."""
        self.prefill_calls += 1
        return paged.paged_prefill(self.params, tokens, lengths, state,
                                   ctx_table, ctx_lens, dest_table,
                                   self.model.config, **self._pkw)

    def _decode_step(self, token, state):
        return paged.paged_decode_step(self.params, token, state,
                                       self.model.config, **self._pkw)

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "PagedInferenceEngine has no standalone generate(): page "
            "allocation lives in the scheduler — drive it through "
            "ContinuousBatchingScheduler / SchedulerService")


class SpeculativeEngine(InferenceEngine):
    """Draft-propose / target-verify pair behind the one-engine contract.

    Wraps a TARGET engine (whose streams are the product) and a smaller
    DRAFT engine of the same family.  A speculative tick at window W:

      1. runs the draft W greedy decode steps from the last emitted token
         (every step writes draft K/V; the last proposal is discarded),
      2. runs the target's verify forward over the W-token window, one
         ``decode_attention`` (K2) or ``paged_decode_attention`` (K3) call
         per window position and layer, committing every position's K/V,
      3. accepts/rejects by exact match against the sequential draws
         (``speculative_accept``); rejected positions roll back as a
         length update alone,

    and returns (draws, counts, next_token, state, ctr + counts): only the
    (B, W) ids and (B,) counts need to reach the host.  Seeded streams
    equal non-speculative decoding by construction (greedy exact, sampled
    draw for draw).  It runs eagerly, like the other engines.

    The combined decode state nests both engines' caches under one shared
    ``length`` (and, when paged, one shared ``page_table``: the two pools
    are indexed by the same pages, so prefix sharing, park pinning and
    rollback cover the pair).  ``decode_sample`` (the plain tick, also the
    adaptive-k level-1 backoff) runs the target alone on a view of the
    combined state; the draft's K/V goes stale for those positions, which
    can only lower acceptance, never change a token.

    Constraints: dense GQA transformers, no sliding window, the same vocab
    and max_len, and — when paged — the same page geometry.
    """

    def __init__(self, target: InferenceEngine, draft: InferenceEngine, *,
                 max_window: int = 4):
        # no super().__init__: the pair's state and programs are the
        # sub-engines'
        tcfg = target.model.config
        dcfg = draft.model.config
        for name, cfg, eng in (("target", tcfg, target),
                               ("draft", dcfg, draft)):
            if cfg.family != "dense" or cfg.attn_kind != "gqa":
                raise ValueError(
                    f"speculative {name} must be a dense GQA transformer, "
                    f"got {cfg.family}/{cfg.attn_kind}")
            if cfg.sliding_window is not None or eng.window is not None:
                raise ValueError(
                    f"speculative {name} cannot use a sliding window")
        if tcfg.vocab_size != dcfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{tcfg.vocab_size}")
        if target.max_len != draft.max_len:
            raise ValueError(
                f"draft max_len {draft.max_len} != target {target.max_len}")
        self.paged = bool(getattr(target, "paged", False))
        if self.paged != bool(getattr(draft, "paged", False)):
            raise ValueError("draft and target must both be paged or dense")
        if self.paged:
            for attr in ("page_size", "num_pages", "max_pages_per_seq"):
                if getattr(target, attr) != getattr(draft, attr):
                    raise ValueError(
                        f"draft {attr} {getattr(draft, attr)} != target "
                        f"{getattr(target, attr)} (the pair shares one "
                        f"page table)")
            self.page_size = target.page_size
            self.max_pages_per_seq = target.max_pages_per_seq
            self.num_pages = target.num_pages
            # a page's admission cost covers both pools
            self.page_bytes = target.page_bytes + draft.page_bytes
            self.ctx_buckets = target.ctx_buckets
        if max_window < 2:
            raise ValueError(f"max_window must be >= 2, got {max_window}")
        self.target = target
        self.draft = draft
        self.model = target.model
        self.params = target.params
        self.device = target.device
        self.max_len = target.max_len
        self.window = None
        self.batch_buckets = target.batch_buckets
        self.seq_buckets = target.seq_buckets
        self.prefill_calls = 0
        self.decode_calls = 0
        self._state_axes = None
        self.speculative = True
        # adaptive-k ladder: 1 (the plain target tick), then powers of two
        self.spec_levels = [1]
        w = 2
        while w <= max_window:
            self.spec_levels.append(w)
            w *= 2
        self.max_window = self.spec_levels[-1]
        # draft/verify device-ms split estimate for telemetry: per-token
        # work is roughly proportional to the parameter bytes read
        t_bytes = _param_bytes(target.params)
        d_bytes = _param_bytes(draft.params)
        self.draft_share = d_bytes / max(t_bytes + d_bytes, 1)

    # --- combined-state plumbing ---------------------------------------------

    @property
    def _shared_keys(self):
        return ("length", "page_table") if self.paged else ("length",)

    def _view(self, state, which: str):
        return {**state[which],
                **{k: state[k] for k in self._shared_keys}}

    def _caches(self, view):
        return {k: v for k, v in view.items() if k not in self._shared_keys}

    def _combine(self, tview, dview):
        out = {"target": self._caches(tview), "draft": self._caches(dview)}
        for k in self._shared_keys:
            out[k] = tview[k]
        return out

    def new_state(self, batch: int, device=None):
        return self._combine(self.target.new_state(batch, device),
                             self.draft.new_state(batch, device))

    # --- prefill / decode ----------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], state):
        """Both halves prefill (the draft must see the prompt to propose);
        the TARGET's first-token logits are the product."""
        self.prefill_calls += 1
        logits, new_t = self.target.prefill(batch,
                                            self._view(state, "target"))
        _, new_d = self.draft.prefill(batch, self._view(state, "draft"))
        return logits, self._combine(new_t, new_d)

    @torch.no_grad()
    def paged_prefill(self, state, tokens, lengths, ctx_table, ctx_lens,
                      dest_table):
        """Paged pair prefill: the draft first, then the target on the
        draft's returned length/page_table (the same tensors: both pass
        through untouched)."""
        self.prefill_calls += 1
        _, new_d = self.draft.paged_prefill(
            self._view(state, "draft"), tokens, lengths, ctx_table,
            ctx_lens, dest_table)
        tview = {**state["target"], "length": new_d["length"],
                 "page_table": new_d["page_table"]}
        logits, new_t = self.target.paged_prefill(
            tview, tokens, lengths, ctx_table, ctx_lens, dest_table)
        return logits, self._combine(new_t, new_d)

    def _stale_draft(self, state, new_tview):
        # plain ticks advance only the target; the draft keeps its (now
        # stale) caches and follows the shared length
        return {**state["draft"],
                **{k: new_tview[k] for k in self._shared_keys}}

    @torch.no_grad()
    def decode(self, token, state):
        self.decode_calls += 1
        logits, new_t = self.target.decode(token,
                                           self._view(state, "target"))
        return logits, self._combine(new_t, self._stale_draft(state, new_t))

    @torch.no_grad()
    def decode_sample(self, token, state, samp: Dict[str, Any], ctr):
        """The plain tick on the pair: the TARGET's decode-and-sample over
        a view of the combined state."""
        self.decode_calls += 1
        toks, new_t, ctr2 = self.target.decode_sample(
            token, self._view(state, "target"), samp, ctr)
        return (toks, self._combine(new_t, self._stale_draft(state, new_t)),
                ctr2)

    # --- the speculative tick ------------------------------------------------

    @torch.no_grad()
    def speculative_step(self, w: int, token, state, samp: Dict[str, Any],
                         ctr, spec_on):
        """One draft-propose + verify + accept tick at window ``w`` (a spec
        level >= 2).  Returns ``(draws (B, w), counts (B), next_token (B),
        new_state, ctr + counts)``: row b emitted ``draws[b, :counts[b]]``;
        rows with ``spec_on[b]`` False advance exactly one token, the
        sequential one.  The caches are written in place."""
        self.decode_calls += 1
        cfg = self.target.model.config
        shared = {k: state[k] for k in self._shared_keys}
        # draft: w greedy proposals from the last emitted token; every
        # step writes draft K/V, so a fully accepted window leaves the
        # draft cache as the sequential steps would
        dview = {**state["draft"], **shared}
        tok, props = token, []
        for _ in range(w):
            logits, dview = self.draft._decode_step(tok, dview)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            props.append(tok)
        drafts = torch.stack(props[:w - 1], dim=1)              # (B, w-1)
        window = torch.cat([token.to(torch.int32)[:, None], drafts], dim=1)
        tview = {**state["target"], **shared}
        if self.paged:
            vlogits, tview = paged.paged_verify_step(
                self.target.params, window, tview, cfg,
                page_size=self.page_size)
        else:
            vlogits, tview = transformer.verify_decode_step(
                self.target.params, window, tview, cfg)
        draws, counts = speculative_accept(
            vlogits, drafts, samp["temperature"], samp["top_k"],
            samp["top_p"], samp["key"], ctr, regime=samp.get("regime"))
        counts = torch.where(spec_on.to(counts.device), counts,
                             torch.ones_like(counts))
        rows = torch.arange(token.shape[0], device=draws.device)
        next_tok = draws[rows, (counts - 1).long()]
        new_state = {"target": self._caches(tview),
                     "draft": self._caches(dview),
                     "length": state["length"] + counts}
        if self.paged:
            new_state["page_table"] = state["page_table"]
        return draws, counts, next_tok, new_state, ctr + counts

    # --- introspection --------------------------------------------------------

    def ctx_bucket_for(self, n_ctx_pages: int) -> int:
        if n_ctx_pages == 0:
            return 0
        return self.ctx_buckets.bucket_for(n_ctx_pages)

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "SpeculativeEngine has no standalone generate(): drive it "
            "through ContinuousBatchingScheduler / SchedulerService")


def page_kv_bytes(cfg, page_size: int) -> int:
    """Device bytes one KV page costs across every layer (k and v): a moe
    config's ``cache_dense`` pool is indexed by the same pages, so its
    first dense layers count with the rest in ``num_layers``."""
    itemsize = torch.empty((), dtype=cache_dtype(cfg)).element_size()
    return (cfg.num_layers * page_size * cfg.num_kv_heads * cfg.head_dim *
            itemsize * 2)


def _map_state(fn, *trees):
    """Apply ``fn`` leaf-wise over decode states of one nesting (dicts of
    dicts of tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_state(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


def pad_batch_rows(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def _pad_rows(x, n, device=None):
    x = np.asarray(x)
    return torch.from_numpy(pad_batch_rows(x, n)).to(device)

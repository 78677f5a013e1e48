"""Continuous batching over a slotted KV pool — many interleaved requests
served by one decode step over every slot.

Port of the JAX package's ``serving/scheduler.py``. ``FedAttnEngine.
generate`` runs one request (batch) to completion; this pool interleaves
requests over a shared KV pool:

* **Block-paged slot pool** (default ``kv_layout='paged'``) — attention KV
  lives in one physical pool of ``(num_pages, page_size)`` blocks per layer
  (:func:`repro_torch.models.transformer.init_paged_cache`), shared by every
  slot; each slot addresses it through an int32 page-table row assembled on
  the host by a refcounted allocator (:mod:`repro_torch.serving.paging`).
  Pool memory is Σ(actual request spans), not ``max_slots × capacity``.
  ``kv_layout='dense'`` keeps one ``(max_slots, capacity)`` row per slot.
* **Prefix cache** (opt-in ``prefix_cache=True``, paged layout) —
  admitted prompts publish their page runs keyed by the exact bytes that
  determine their KV (tokens, segments, sparse-exchange masks); a later
  admission sharing a cached prefix maps those pages copy-free into its
  table and prefills only the suffix (:meth:`FedAttnEngine._prefill_rows`
  with per-row write frontiers). A partially filled boundary page is
  copied into a fresh page (copy-on-write) so shared bytes stay immutable.
* **One decode step over all slots** per tick. Everything that tells slots
  apart — write frontier, query position, segment vectors, temperature,
  sampling seed, token index — is a per-slot tensor. Inactive slots ride
  along fully masked (segment ``PAD_SEGMENT`` hides their pages from every
  query; their page tables are all sentinel, so their writes drop).
  On the 'cuda' backend every paged decode and verify step reads the pool
  through K2 (:mod:`repro_torch.kernels.flash_decode`), once per layer.
* **Coalesced admission** — each tick collects every admissible request,
  groups them by prefill bucket and runs ONE B>1 prefill per group (K1 on
  'cuda'). The batch size is pow2-padded so the set of admission shapes
  stays small; padding rows replicate a real request and are dropped at
  the slot write.
* **Per-slot speculative decoding** (opt-in ``spec_k > 0``) — a host-side
  drafter (:mod:`repro_torch.serving.spec`) proposes ``k`` tokens per slot
  per tick and ONE multi-token verify step scores all ``k+1`` positions of
  every slot. Per-slot accept lengths become ragged frontier advances.
  Rejected draft rows need no scrub: the next tick's write block starts at
  the accepted frontier and overwrites them before any query reaches them.
* **Quantized pools** (``kv_quant='int8'/'fp8'``, paged layout) and the
  **'attnmass'** accumulator (``kv_selection='attnmass'`` with a ratio
  below 1): the decode step feeds each slot's per-column attention mass
  into an ``am`` leaf and ranks sync-layer exchange by it.

Per-request parity: a request scheduled through the pool produces the same
tokens as a standalone ``engine.generate`` call with the same seed and
partition — decode-step math is row-independent and sampling uses the
engine's counter-based noise, token ``m`` drawing the noise of
(seed, row 0, ``m``).

Left out against the JAX scheduler: the SPMD pool (a serving mesh), scan
``layers_mode`` and the executable budgets — PyTorch compiles nothing.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.partition import Partition
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels.core import PAD_SEGMENT
from repro_torch.models import transformer as T
from repro_torch.serving import paging
from repro_torch.serving.engine import (
    GenerationResult, _next_pow2, _signed64, _token_logprob, sample, verify_candidates,
)
from repro_torch.serving.spec import resolve_drafter


@dataclass
class Request:
    """One decode request: the unit the scheduler interleaves. Semantics
    equal the matching ``engine.generate(tokens[None], n_new,
    partition=..., temperature=..., generator=...)`` call: ``generator``
    draws the 'random' sparse-exchange masks and seeds the sampler;
    ``temperature > 0`` without a generator decodes greedily."""

    tokens: object  # (L,) or (1, L) prompt token ids, array or tensor
    n_new: int
    partition: Optional[Partition] = None
    temperature: float = 0.0
    generator: Optional[torch.Generator] = None


@dataclass
class _Slot:
    """Host-side bookkeeping for one occupied pool slot."""

    req_id: int
    real_len: int
    n_new: int
    n_emitted: int  # tokens produced so far (tok0 counts)
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)
    comm_bytes: float = 0.0
    pages: list = field(default_factory=list)  # owned page refs (paged layout)
    t_start: float = 0.0  # effective request start (submit/arrival clock)
    t_first: float = 0.0  # first token available (TTFT = t_first - t_start)


class ContinuousBatchingScheduler:
    """Admit → step → retire loop over a fixed slot pool.

    Args:
      engine: a :class:`repro_torch.serving.engine.FedAttnEngine` (its
        device, backend, bucket policy and per-row prefill are reused).
      max_slots: pool rows = maximum concurrently-decoding requests.
      capacity: KV positions per slot. Every admitted request needs
        ``bucketed_prefill_len <= capacity`` and ``L + n_new <= capacity``.
      steps_per_admit: decode sub-steps per tick between admissions.
        Finished slots coast; their surplus tokens are discarded.
      kv_layout: ``'paged'`` (default) or ``'dense'``.
      page_size: tokens per physical page (paged layout). The working
        capacity rounds up to whole pages; ``capacity`` stays the
        admission bound.
      num_pages: physical pages in the pool; default ``max_slots *
        ceil(capacity / page_size)`` (the dense layout's bytes). Smaller
        pools oversubscribe: admission waits, FIFO, for pages.
      prefix_cache: share cached prompt prefixes across admissions (paged).
      spec_k: speculative draft length (0: one token per tick). Requires
        ``steps_per_admit == 1``.
      drafter: ``'ngram'`` (default) or an object with ``begin``/``draft``/
        ``update``.
      kv_quant: ``'int8'``/``'fp8'`` pool codes with per-page-per-head
        scales (paged layout); None inherits the engine's setting,
        ``'none'`` forces it off.
    """

    def __init__(
        self,
        engine,
        *,
        max_slots: int = 8,
        capacity: int = 256,
        steps_per_admit: int = 1,
        kv_layout: str = "paged",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = False,
        spec_k: int = 0,
        drafter=None,
        kv_quant: Optional[str] = None,
    ):
        if max_slots < 1 or capacity < 2 or steps_per_admit < 1:
            raise ValueError("max_slots >= 1, capacity >= 2, steps_per_admit >= 1")
        if kv_layout not in ("paged", "dense"):
            raise ValueError("kv_layout must be 'paged' or 'dense'")
        if kv_quant is None:
            kv_quant = engine.kv_quant
        elif kv_quant == "none":
            kv_quant = None
        if kv_quant is not None and kv_layout != "paged":
            raise ValueError("kv_quant requires kv_layout='paged': the dense slot rows "
                             "have no per-page scales")
        if page_size < 1:
            raise ValueError("page_size >= 1")
        if spec_k < 0:
            raise ValueError("spec_k >= 0")
        if spec_k > 0 and steps_per_admit != 1:
            raise ValueError("spec_k > 0 requires steps_per_admit == 1: the drafter runs "
                             "on the host between verify ticks")
        g = engine.config.n_heads // engine.config.n_kv_heads
        if kv_layout == "paged" and engine.backend == "cuda" and (
                g * (spec_k + 1) > _fd.MAX_ROWS or page_size > _fd.MAX_PAGE_SIZE):
            raise ValueError(
                f"backend 'cuda': K2 serves g*(spec_k+1) <= {_fd.MAX_ROWS} query rows per KV head "
                f"and pages of <= {_fd.MAX_PAGE_SIZE} tokens; got g*(spec_k+1)={g * (spec_k + 1)}, "
                f"page_size={page_size}")
        self.kv_quant = kv_quant
        self.spec_k = spec_k
        self._drafter = resolve_drafter(drafter) if spec_k > 0 else None
        self.engine = engine
        self.device = engine.device
        self.max_slots = max_slots
        self.capacity = capacity
        self.steps_per_admit = steps_per_admit
        self.page_size = page_size
        self._paged = kv_layout == "paged"
        cfg = engine.config

        if self._paged:
            self._cap = paging.padded_capacity(capacity, page_size)
            self._pp = paging.pages_for(self._cap, page_size)  # table width
            if num_pages is None:
                num_pages = max_slots * self._pp
            elif num_pages < 1:
                raise ValueError("num_pages >= 1")
            self.num_pages = num_pages
            self._alloc = paging.PageAllocator(num_pages)
            self._prefix = paging.PrefixCache(self._alloc, page_size) if prefix_cache else None
            fed = engine.fed
            self._mass_width = (
                self._cap if fed.kv_selection == "attnmass" and fed.kv_exchange_ratio < 1.0
                else None
            )
            self.cache = T.init_paged_cache(
                cfg, max_slots, num_pages, page_size, device=self.device,
                kv_quant=kv_quant, mass_width=self._mass_width,
            )
        else:
            if prefix_cache:
                raise ValueError("prefix_cache requires kv_layout='paged'")
            self._mass_width = None
            self._cap = capacity
            self._pp = 0
            self.num_pages = 0
            self._alloc = None
            self._prefix = None
            self.cache = engine.model.init_cache(max_slots, capacity, device=self.device)

        S, C = max_slots, self._cap
        self._slots: list[Optional[_Slot]] = [None] * S
        # per-slot page tables; entry ``num_pages`` is the hole sentinel
        self._pages_tbl = np.full((S, self._pp), self.num_pages, np.int32) if self._paged else None
        self.stats = {
            "full_prefills": 0,
            "suffix_prefills": 0,
            "prefill_tokens": 0,
            "peak_resident": 0,
            "peak_resident_tokens": 0,
            # pooled forward passes (decode sub-steps and verify ticks): each
            # runs every layer's attention once over all slots
            "ticks": 0,
            # speculative counters: acceptance rate = spec_accepted / spec_drafted
            "spec_drafted": 0,
            "spec_accepted": 0,
            "verify_ticks": 0,
        }
        self._lat = {"ttft": [], "tpot": []}
        self._submit_t: dict[int, float] = {}
        self._queue: deque = deque()  # (req_id, Request, arrival_time|None)
        self._results: dict[int, GenerationResult] = {}
        self._next_id = 0

        # per-slot step inputs (host mirrors, pushed every tick)
        self._tok = np.zeros(S, np.int64)  # last emitted token
        self._write_pos = np.zeros(S, np.int64)  # its KV slot = its position
        self._fold = np.zeros(S, np.int64)  # token index of the NEXT token
        self._qseg = np.full(S, PAD_SEGMENT, np.int32)
        self._kvseg = np.full((S, C), PAD_SEGMENT, np.int32)  # PAD ⇒ invisible
        self._temps = np.ones(S, np.float32)
        self._sampled = np.zeros(S, bool)
        self._seeds = np.zeros(S, np.int64)
        self._draft_state: list = [None] * S
        # wide per-slot tensors, rebuilt only when the slot set changes
        self._slot_args = None
        self._proto = engine._proto_ctx(C)
        self._kv_pos = torch.arange(C, dtype=torch.int32, device=self.device)

    # -- introspection ----------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def done(self) -> bool:
        return not self._queue and self.n_active == 0

    # -- submission -------------------------------------------------------------

    def submit(self, request: Request, *, arrival_time: Optional[float] = None) -> int:
        """Queue a request; returns its id (key into ``results``).
        ``arrival_time`` (time.perf_counter clock) defers admission."""
        toks = np.asarray(torch.as_tensor(request.tokens).cpu())
        if toks.ndim == 2:
            if toks.shape[0] != 1:
                raise ValueError("scheduler requests are single-sequence (B=1)")
            toks = toks[0]
        L = int(toks.shape[0])
        Lp = self.engine._bucket_len(L)
        if max(Lp, L + request.n_new) > self.capacity:
            raise ValueError(
                f"request needs {max(Lp, L + request.n_new)} KV positions "
                f"(L={L}, bucketed {Lp}, n_new={request.n_new}) but slots hold {self.capacity}"
            )
        if request.n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {request.n_new}")
        req = dataclasses.replace(request, tokens=toks.astype(np.int64))
        rid = self._next_id
        self._next_id += 1
        self._submit_t[rid] = time.perf_counter()
        self._queue.append((rid, req, arrival_time))
        return rid

    @property
    def results(self) -> dict[int, GenerationResult]:
        """Completed results by request id (claim them with :meth:`pop_result`)."""
        return self._results

    def pop_result(self, rid: int) -> Optional[GenerationResult]:
        return self._results.pop(rid, None)

    @staticmethod
    def capacity_for(engine, requests) -> int:
        """Smallest slot capacity serving every request: the bucketed
        prefill length and the prompt+generation span must both fit."""
        need = 2
        for r in requests:
            L = int(np.asarray(torch.as_tensor(r.tokens).cpu()).reshape(-1).shape[0])
            need = max(need, engine._bucket_len(L), L + r.n_new)
        return need

    # -- admission --------------------------------------------------------------

    def _prefix_key(self, req, ctx):
        """Length-indexed digest of everything that determines a prompt's
        KV bytes: token ids, partition segments, exchange masks."""
        toks = np.asarray(req.tokens, np.int32)
        segs = ctx.segments.cpu().numpy()
        contrib = None if ctx.contributed is None else ctx.contributed.cpu().numpy()

        def key_of(d: int) -> bytes:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(d).tobytes())
            h.update(toks[:d].tobytes())
            h.update(segs[:d].tobytes())
            if contrib is not None:
                h.update(np.ascontiguousarray(contrib[:, :d]).tobytes())
            return h.digest()

        return key_of

    def _alloc_pages(self, n: int):
        """All-or-nothing allocation, evicting prefix-cache LRU entries under
        pressure. None ⇒ the pool cannot hold ``n`` more pages now."""
        if n == 0:
            return []
        out = self._alloc.alloc(n)
        while out is None and self._prefix is not None and self._prefix.evict_lru():
            out = self._alloc.alloc(n)
        return out

    def _prepare_admission(self, rid: int, req: Request):
        """The request's context and — paged layout — its page plan: prefix
        lookup, shared full prefix pages, a copy-on-write page when the
        prefix ends mid-page, fresh pages for the rest. None when the pool
        cannot hold it now (every ref taken here is rolled back; admission
        stays FIFO)."""
        eng = self.engine
        L = int(req.tokens.shape[0])
        ctx = eng.build_context(L, partition=req.partition, generator=req.generator)
        adm = {
            "rid": rid, "req": req, "ctx": ctx, "L": L, "d": 0,
            "pages": [], "dst": None, "src": None, "table": None,
            "key_of": None, "t0": None,
        }
        if not self._paged:
            return adm
        ps, N = self.page_size, self.num_pages
        n_total = min(paging.pages_for_request(L, req.n_new, ps, spec_k=self.spec_k), self._pp)
        d, run = 0, ()
        if self._prefix is not None:
            adm["key_of"] = self._prefix_key(req, ctx)
            hit = self._prefix.lookup(adm["key_of"], L)
            if hit is not None:
                d, run = hit
        n_shared = paging.pages_for(d, ps)
        partial = d > 0 and paging.page_split(d, ps)[1] != 0
        owned: list = []
        table = np.full(self._pp, N, np.int32)
        dst = np.full(self._pp, N, np.int32)
        src = np.full(self._pp, N, np.int32)
        # shared prefix pages: read through (src, table), never written (dst
        # stays the sentinel)
        for j, p in enumerate(run[:n_shared]):
            self._alloc.incref(p)
            owned.append(p)
            src[j] = table[j] = p
        if partial:
            # copy-on-write: the suffix prefill reads the shared boundary
            # page and the slot write lands a private copy with the prefix
            # bytes plus the suffix; the slot keeps its ref on the original
            # until retirement
            copy = self._alloc_pages(1)
            if copy is None:
                for p in owned:
                    self._alloc.free(p)
                return None
            j = n_shared - 1
            dst[j] = table[j] = copy[0]
            owned.append(copy[0])
        fresh = self._alloc_pages(n_total - n_shared)
        if fresh is None:
            for p in owned:
                self._alloc.free(p)
            return None
        for j, p in enumerate(fresh):
            dst[n_shared + j] = table[n_shared + j] = p
            owned.append(p)
        adm.update(d=d, pages=owned, dst=dst, src=src, table=table)
        return adm

    def pool_stats(self) -> dict:
        """Memory and prefix-cache counters: ``bytes_per_resident_token`` is
        the whole pool over the tokens actually resident."""
        resident = sum(o.real_len + o.n_emitted for o in self._slots if o is not None)
        pool_bytes = sum(t.numel() * t.element_size() for c in self.cache for t in c.values())
        out = {
            "kv_layout": "paged" if self._paged else "dense",
            "pool_bytes": int(pool_bytes),
            "resident_tokens": int(resident),
            "bytes_per_resident_token": float(pool_bytes) / max(1, resident),
            "peak_bytes_per_resident_token": (
                float(pool_bytes) / max(1, self.stats["peak_resident_tokens"])
            ),
            **self.stats,
        }
        if self._paged:
            out["num_pages"] = self.num_pages
            out["page_size"] = self.page_size
            out["used_pages"] = self._alloc.used_pages
            out["free_pages"] = self._alloc.free_pages
        if self._prefix is not None:
            out["prefix_hits"] = self._prefix.hits
            out["prefix_misses"] = self._prefix.misses
            out["prefix_evictions"] = self._prefix.evictions
            out["prefix_tokens_reused"] = self._prefix.tokens_reused
            out["prefix_entries"] = len(self._prefix)
        if self.spec_k > 0:
            out["spec_k"] = self.spec_k
            out["spec_acceptance_rate"] = (
                self.stats["spec_accepted"] / max(1, self.stats["spec_drafted"])
            )
        out.update(self.latency_stats())
        return out

    def latency_stats(self, *, reset: bool = False) -> dict:
        """Per-request latency percentiles (seconds) over every request
        retired so far: ``ttft`` — from the later of submission and arrival
        to the first token; ``tpot`` — retirement minus first token over
        ``n_new - 1`` (requests with ``n_new > 1``)."""
        out: dict = {}
        for name, xs in self._lat.items():
            out[f"{name}_n"] = len(xs)
            if xs:
                out[f"{name}_p50"] = float(np.percentile(xs, 50))
                out[f"{name}_p95"] = float(np.percentile(xs, 95))
        if reset:
            for xs in self._lat.values():
                xs.clear()
        return out

    def _admit_group(self, slots: list[int], adms: list, Lp: int, *, suffix: bool = False) -> None:
        """Admit same-bucket requests with ONE B>1 prefill, pow2-padded
        (padding rows replicate request 0 and are dropped at the slot
        write). ``suffix=True`` (prefix-cache hits): ``Lp`` buckets the
        suffixes; each row's cached prefix KV is gathered from the pool
        through its source table and only the suffix runs."""
        eng = self.engine
        dev = self.device
        B, C = len(adms), self._cap
        tokens = np.zeros((B, Lp), np.int64)
        real_len = np.ones(B, np.int64)
        write_lo = np.zeros(B, np.int32)
        q_seg = np.full((B, Lp), PAD_SEGMENT, np.int32)
        kv_seg = np.zeros((B, C), np.int32)
        temps = np.ones(B, np.float32)
        sampled = np.zeros(B, bool)
        seeds = np.zeros(B, np.int64)
        contrib_rows = []
        for i, a in enumerate(adms):
            req, ctx, L, d = a["req"], a["ctx"], a["L"], a["d"]
            tokens[i, : L - d] = req.tokens[d:]
            real_len[i] = L - d
            write_lo[i] = d
            q_seg[i, : L - d] = ctx.segments.cpu().numpy()[d:]
            kv_seg[i] = ctx.decode_kv_segments(C).cpu().numpy()
            temps[i] = max(req.temperature, 1e-6)
            sampled[i] = req.temperature > 0.0 and req.generator is not None
            seeds[i] = _signed64(req.generator.initial_seed()) if sampled[i] else 0
            if ctx.contributed is not None:
                row = np.zeros((ctx.contributed.shape[0], C), bool)
                row[:, : ctx.contributed.shape[1]] = ctx.contributed.cpu().numpy()
                contrib_rows.append(row)

        Bp = _next_pow2(B)
        pad = lambda a: torch.as_tensor(
            np.concatenate([a, np.broadcast_to(a[:1], (Bp - B,) + a.shape[1:])]) if Bp > B else a,
            device=dev,
        )
        contributed = pad(np.stack(contrib_rows)) if contrib_rows else None
        if suffix:
            src = np.full((Bp, self._pp), self.num_pages, np.int32)
            src[:B] = np.stack([a["src"] for a in adms])
            one = T.gather_paged_cache(self.cache, torch.as_tensor(src, device=dev))
            last = eng._prefill_rows(
                one, pad(tokens), pad(real_len), pad(q_seg), pad(kv_seg), contributed,
                write_lo=pad(write_lo),
            )
        else:
            one = eng.model.init_cache(Bp, C, device=dev)
            last = eng._prefill_rows(one, pad(tokens), pad(real_len), pad(q_seg), pad(kv_seg),
                                     contributed)
        last = last[:B]
        zeros = torch.zeros(B, dtype=torch.int64, device=dev)
        tok0 = sample(last, torch.as_tensor(temps, device=dev), torch.as_tensor(seeds, device=dev),
                      zeros, zeros, torch.as_tensor(sampled, device=dev))
        lp0 = _token_logprob(last, tok0)
        slot_idx = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        if self._paged:
            dst = np.full((Bp, self._pp), self.num_pages, np.int32)
            dst[:B] = np.stack([a["dst"] for a in adms])
            T.paged_slot_write(self.cache, one, torch.as_tensor(dst, device=dev),
                               torch.as_tensor(slots + [self.max_slots] * (Bp - B), device=dev))
        else:
            for pc, bc in zip(self.cache, one):
                for key in ("k", "v"):
                    pc[key][slot_idx] = bc[key][:B].to(pc[key].dtype)

        tok0 = tok0.cpu().numpy()
        lp0 = lp0.cpu().numpy()
        t_now = time.perf_counter()  # tok0 is on the host: the first token exists
        for i, a in enumerate(adms):
            slot, ctx, req, rid = slots[i], a["ctx"], a["req"], a["rid"]
            L, d = a["L"], a["d"]
            self._tok[slot] = int(tok0[i])
            self._write_pos[slot] = L  # tok0's KV goes to position L next tick
            self._fold[slot] = 1  # token m draws the noise of step m
            self._qseg[slot] = ctx.partition.publisher(ctx.config.publisher_index)
            self._kvseg[slot] = kv_seg[i]
            self._temps[slot] = temps[i]
            self._sampled[slot] = sampled[i]
            self._seeds[slot] = seeds[i]
            if self._paged:
                self._pages_tbl[slot] = a["table"]
            t0 = a["t0"] if a["t0"] is not None else t_now
            self._lat["ttft"].append(t_now - t0)
            self._slots[slot] = _Slot(
                req_id=rid, real_len=L, n_new=req.n_new, n_emitted=1,
                tokens=[int(tok0[i])], logprobs=[float(lp0[i])],
                comm_bytes=ctx.comm_bytes_per_participant(
                    eng.config.n_kv_heads, eng.config.head_dim
                ),
                pages=a["pages"], t_start=t0, t_first=t_now,
            )
            if self.spec_k > 0:
                self._draft_state[slot] = self._drafter.begin(list(req.tokens) + [int(tok0[i])])
            if suffix:
                self.stats["suffix_prefills"] += 1
                self.stats["prefill_tokens"] += L - d
            else:
                self.stats["full_prefills"] += 1
                self.stats["prefill_tokens"] += L
            if self._prefix is not None and a["key_of"] is not None:
                # publish before an n_new == 1 retirement frees the slot's refs
                self._prefix.insert(
                    a["key_of"], L,
                    [int(p) for p in a["table"][: paging.pages_for(L, self.page_size)]],
                )
            if req.n_new == 1:
                self._retire(slot)
        self._slot_args = None

    def _retire(self, slot: int) -> None:
        occ = self._slots[slot]
        self._results[occ.req_id] = GenerationResult(
            tokens=np.asarray(occ.tokens, np.int64)[None, : occ.n_new],
            logprobs=np.asarray(occ.logprobs, np.float64)[None, : occ.n_new],
            prefill_comm_bytes=occ.comm_bytes,
        )
        if occ.n_new > 1:
            self._lat["tpot"].append((time.perf_counter() - occ.t_first) / (occ.n_new - 1))
        self._slots[slot] = None
        self._draft_state[slot] = None
        # hide the freed pages from every query until the next occupant
        self._kvseg[slot] = PAD_SEGMENT
        self._qseg[slot] = PAD_SEGMENT
        self._sampled[slot] = False
        if self._paged:
            for p in occ.pages:
                self._alloc.free(p)
            self._pages_tbl[slot] = self.num_pages  # a coasting write drops
        self._slot_args = None

    # -- the pooled decode step -------------------------------------------------

    def _wide_args(self):
        """Per-slot tensors that change only when the slot set does."""
        if self._slot_args is None:
            dev = self.device
            self._slot_args = dict(
                q_seg=torch.as_tensor(self._qseg, device=dev),
                kv_seg=torch.as_tensor(self._kvseg, device=dev),
                temps=torch.as_tensor(self._temps, device=dev),
                sampled=torch.as_tensor(self._sampled, device=dev),
                seeds=torch.as_tensor(self._seeds, device=dev),
                pages=torch.as_tensor(self._pages_tbl, device=dev) if self._paged else None,
            )
        return self._slot_args

    def _forward(self, tokens, write_pos, positions, segments, w):
        """One pooled forward over every slot: logits (S, S_new, V)."""
        eng = self.engine
        dctx = dataclasses.replace(
            self._proto, positions=positions, segments=segments,
            kv_positions=self._kv_pos, kv_segments=w["kv_seg"], contributed=None,
        )
        self.stats["ticks"] += 1
        return eng.model.decode_step(
            eng.params, self.cache, tokens, write_pos, self._proto,
            backend=eng.backend, dctx=dctx, pages=w["pages"],
        )

    def _decode(self, w):
        """``steps_per_admit`` single-token sub-steps; (k, S) tokens and
        logprobs on the host."""
        dev = self.device
        tok = torch.as_tensor(self._tok, device=dev)
        wp = torch.as_tensor(self._write_pos, device=dev)
        fold = torch.as_tensor(self._fold, device=dev)
        rows = torch.zeros_like(tok)
        toks, lps = [], []
        for _ in range(self.steps_per_admit):
            logits = self._forward(tok[:, None], wp, wp[:, None].int(), w["q_seg"][:, None], w)
            last = logits[:, -1]
            tok = sample(last, w["temps"], w["seeds"], rows, fold, w["sampled"])
            toks.append(tok)
            lps.append(_token_logprob(last, tok))
            wp, fold = wp + 1, fold + 1
        return torch.stack(toks).cpu().numpy(), torch.stack(lps).cpu().numpy()

    def _verify(self, w, draft: np.ndarray):
        """One speculative verify tick: candidates (S, k+1), their logprobs
        and the accept lengths (S,), on the host."""
        dev = self.device
        tok = torch.as_tensor(self._tok, device=dev)
        inp = torch.cat([tok[:, None], torch.as_tensor(draft, device=dev)], dim=1)
        wp = torch.as_tensor(self._write_pos, device=dev)
        pos = (wp[:, None] + torch.arange(self.spec_k + 1, device=dev)[None, :]).int()
        logits = self._forward(inp, wp, pos, w["q_seg"][:, None].expand(pos.shape), w)
        cand, lps, acc = verify_candidates(
            logits, inp[:, 1:], w["temps"], w["seeds"],
            torch.as_tensor(self._fold, device=dev), w["sampled"],
        )
        return cand.cpu().numpy(), lps.cpu().numpy(), acc.cpu().numpy()

    # -- the scheduler tick -----------------------------------------------------

    def step(self, *, now: Optional[float] = None) -> bool:
        """One tick: admit every arrived request into free slots (one
        coalesced prefill per bucket), run one pooled decode call, retire
        finished slots. Returns True if any decode work ran."""
        free = [s for s, occ in enumerate(self._slots) if occ is None]
        batch: list = []
        while self._queue and len(batch) < len(free):
            rid, req, at = self._queue[0]
            if at is not None and at > (now if now is not None else time.perf_counter()):
                break
            adm = self._prepare_admission(rid, req)
            if adm is None:
                # page pool exhausted (even after prefix-cache eviction):
                # the request waits at the head of the queue — FIFO
                break
            self._queue.popleft()
            t0 = self._submit_t.pop(rid, None)
            if t0 is None:
                t0 = time.perf_counter()
            adm["t0"] = t0 if at is None else max(t0, at)
            batch.append(adm)
        if batch:
            groups: dict = {}
            for adm in batch:
                Lp = self.engine._bucket_len(adm["L"] - adm["d"])
                groups.setdefault((Lp, adm["d"] > 0), []).append(adm)
            for (Lp, suffix), adms in groups.items():
                self._admit_group([free.pop(0) for _ in adms], adms, Lp, suffix=suffix)
            self.stats["peak_resident"] = max(self.stats["peak_resident"], self.n_active)
            self.stats["peak_resident_tokens"] = max(
                self.stats["peak_resident_tokens"],
                sum(o.real_len + o.n_emitted for o in self._slots if o is not None),
            )

        if self.n_active == 0:
            return False
        w = self._wide_args()

        if self.spec_k > 0:
            # host-side drafting; inactive rows keep zeros (masked anyway)
            draft = np.zeros((self.max_slots, self.spec_k), np.int64)
            for s, occ in enumerate(self._slots):
                if occ is not None:
                    draft[s] = self._drafter.draft(self._draft_state[s], self.spec_k)
            cand, lps, acc = self._verify(w, draft)
            self.stats["verify_ticks"] += 1
            for s, occ in enumerate(self._slots):
                if occ is None:
                    continue
                a = int(acc[s])
                take = min(a + 1, occ.n_new - occ.n_emitted)
                occ.tokens.extend(int(t) for t in cand[s, :take])
                occ.logprobs.extend(float(x) for x in lps[s, :take])
                occ.n_emitted += take
                self._tok[s] = int(cand[s, take - 1])
                self._write_pos[s] += take
                self._fold[s] += take
                self._drafter.update(self._draft_state[s], cand[s, :take])
                self.stats["spec_drafted"] += self.spec_k
                self.stats["spec_accepted"] += min(a, take)
                if occ.n_emitted >= occ.n_new:
                    self._retire(s)
            return True

        toks, lps = self._decode(w)
        k = self.steps_per_admit
        for s, occ in enumerate(self._slots):
            if occ is None:
                continue
            take = min(k, occ.n_new - occ.n_emitted)
            occ.tokens.extend(int(t) for t in toks[:take, s])
            occ.logprobs.extend(float(x) for x in lps[:take, s])
            occ.n_emitted += take
            self._tok[s] = int(toks[-1, s])
            self._write_pos[s] += k
            self._fold[s] += k
            if occ.n_emitted >= occ.n_new:
                self._retire(s)
        return True

    # -- drive to completion ----------------------------------------------------

    def run(self, requests: Sequence[Request],
            arrival_times: Optional[Sequence[float]] = None) -> list[GenerationResult]:
        """Submit ``requests`` (optionally with perf_counter arrival offsets
        from now) and drive the loop until all complete; results in
        request order."""
        t0 = time.perf_counter()
        ids = [
            self.submit(r, arrival_time=None if arrival_times is None else t0 + arrival_times[i])
            for i, r in enumerate(requests)
        ]
        while not self.done():
            if not self.step():
                nxt = min((at for _, _, at in self._queue if at is not None), default=None)
                if nxt is not None:
                    time.sleep(max(0.0, nxt - time.perf_counter()))
        return [self._results.pop(i) for i in ids]

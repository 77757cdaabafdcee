"""Continuous-batching decode engine: token-level scheduling over a
device-resident paged KV cache.

Counterpart of ``mxnet_tpu/serve/decode.py`` without fault injection,
the profiler's host-sync records and the lowered-program gates. LM
generation is ragged and long-lived,
so one slow sequence must not idle the batch: this engine keeps a
fixed-capacity slot batch ``[max_slots, 1]`` hot and ADMITS/EVICTS
sequences BETWEEN decode steps.

* **Fixed shapes.** Every decode step runs the same function at the
  same shapes. Scheduling state (which slot is live, which pages it
  owns, its position) lives in small host numpy arrays copied to the
  device each step. Inactive slots point at the reserved scratch page
  0; there is no active mask.
* **Paged KV cache.** ``(num_layers, num_pages * page_size, dim)`` K
  and V tensors stay on the device for the session's lifetime and are
  updated IN PLACE (``index_copy_``); no step allocates a new cache and
  the cache never goes to the host.
* **Prefill/decode separation.** Prompts run through the bucketed
  engine cache at ONE bucket (``max_slots``), so every group size runs
  the same shapes and a request's tokens do not depend on its
  batchmates; their K/V rows are then copied into freshly allocated
  pages on the device. Prompts longer than ``max_prompt_len`` stream
  through ``chunk_prefill`` (format_version 5).
* **Speculative decoding.** On an artifact that bundles the int8 draft,
  each step is one ``draft_verify`` call: k int8 draft token-steps over
  a second (draft) cache with the verifier cache's geometry, one f32
  verifier pass over the (k+1)-token window and the acceptance rule.
  Every emitted token is the verifier's position-keyed sample, so the
  tokens are the plain engine's at any temperature; the draft only sets
  how many a step emits. The draft cache shares the verifier cache's
  page accounting and block tables, and each request reserves
  ``speculate_k`` more rows so the window never writes into another
  sequence's pages.
* **Estimates from a roofline.** Admission retry-after and drain budgets
  come from :func:`roofline_seconds` over the decode step's flops and
  bytes.

Host-sync budget: ONE device-to-host copy per decode step (the sampled
tokens, or the speculative step's packed array) and one per prefill
group (the first tokens) or long prompt (its final chunk's token);
``d2h_copies`` counts them. The scheduler
thread runs under ``torch.inference_mode()``, which is thread-local, so
it is entered there.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as _np
import torch

from ..base import MXNetError
from ..config import flags
from ..perfmodel import roofline_seconds
from ..serving import GenerateModel, load_artifact
from .admission import (DeadlineExceeded, Evicted, ServerBusy,
                        ServerClosed)
from .metrics import DecodeMetrics

__all__ = ["GenerateSession", "GenerateConfig", "GenerateRequest",
           "PagedKVCache", "roofline_seconds"]

class GenerateConfig:
    """Decode-engine knobs; defaults come from the MXNET_SERVE_* flags.

    ``continuous=False`` degrades to STATIC batching: a group is
    admitted only when every slot is free and runs to the last
    straggler. It exists as a baseline (same functions, same cache);
    never serve with it.

    ``speculative``: None speculates iff the artifact bundles a draft;
    True requires the draft (the session raises without one); False
    decodes one token a step even on a speculative artifact.
    """

    def __init__(self, queue_depth=None, timeout_ms=None,
                 drain_tokens=None, drain_timeout_s=None,
                 window_steps=None, max_new_tokens=64, continuous=True,
                 warmup=None, speculative=None):
        self.queue_depth = (flags.serve_queue_depth if queue_depth is None
                            else int(queue_depth))
        self.timeout_ms = (flags.serve_timeout_ms if timeout_ms is None
                           else float(timeout_ms))
        self.drain_tokens = (flags.serve_drain_tokens
                             if drain_tokens is None else int(drain_tokens))
        self.drain_timeout_s = (flags.serve_drain_timeout_s
                                if drain_timeout_s is None
                                else float(drain_timeout_s))
        self.window_steps = (flags.serve_decode_window
                             if window_steps is None else int(window_steps))
        self.max_new_tokens = int(max_new_tokens)
        self.continuous = bool(continuous)
        self.warmup = warmup
        self.speculative = speculative


class GenerateRequest:
    """One admitted generation. ``result()`` blocks for a dict with
    ``tokens`` / ``finish_reason`` ("stop" | "length") / ``ttft_ms`` /
    ``tpot_ms`` / ``latency_ms``. Eviction raises :class:`Evicted`
    carrying the partial tokens and a resumable cursor."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "deadline", "t_submit", "ttft_ms", "_event", "_result",
                 "_error")

    def __init__(self, prompt, max_new_tokens, temperature, seed,
                 deadline):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed) & 0x7FFFFFFF
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.ttft_ms = None
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                "serve: no generation result within %.3fs" % (timeout or 0))
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result):
        self._result = result
        self._event.set()

    def _fail(self, exc):
        self._error = exc
        self._event.set()


class PagedKVCache:
    """Device-resident paged K/V store + host-side page accounting.

    The device side is two ``(num_layers, num_pages * page_size, dim)``
    f32 tensors, only ever updated in place. The host side is a free list
    over pages ``1..num_pages-1``; page 0 is the scratch page inactive
    slots and padding rows write into, and is never allocated.
    """

    def __init__(self, spec, device):
        self.spec = spec
        shape = (spec.num_layers, spec.cache_rows, spec.dim)
        self.k = torch.zeros(shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=device)
        # ascending allocation order (pop from the end of a descending
        # list) keeps page ids deterministic for tests
        self._free = list(range(spec.num_pages - 1, 0, -1))

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def total_pages(self):
        """Allocatable pages (scratch excluded)."""
        return self.spec.num_pages - 1

    def occupancy(self):
        return 1.0 - (len(self._free) / float(self.total_pages))

    def pages_needed(self, total_tokens):
        return -(-int(total_tokens) // self.spec.page_size)

    def alloc(self, n):
        if n > len(self._free):
            raise MXNetError("PagedKVCache: %d page(s) requested, %d free"
                             % (n, len(self._free)))
        return [self._free.pop() for _ in range(n)]

    def free(self, pages):
        self._free.extend(sorted(pages, reverse=True))


class _Slot:
    __slots__ = ("req", "pages", "gen", "t_first", "drain_cap",
                 "spec_steps", "accepted")

    def __init__(self, req, pages):
        self.req = req
        self.pages = pages
        self.gen = []            # every sampled token, first included
        self.t_first = None      # wall stamp of the first token
        self.drain_cap = None    # len(gen) bound once draining
        self.spec_steps = 0      # speculative steps this slot rode
        self.accepted = 0        # draft tokens among its emitted ones


class GenerateSession:
    """Continuous-batching generation over one generate artifact.

    In-process use (tests)::

        sess = GenerateSession("model.gen.mxtorch", device="cpu")
        req = sess.submit(prompt=[3, 1, 4], max_new_tokens=16)
        out = req.result(timeout=10.0)       # {"tokens": [...], ...}
        sess.close(drain=True)

    ``model`` is a loaded :class:`GenerateModel` or an artifact path,
    loaded onto ``device`` (default cuda:0). ``auto_start=False`` leaves
    the scheduler thread unstarted; drive it deterministically with
    :meth:`run_round` (one admit + evict + step).
    """

    def __init__(self, model, config=None, auto_start=True, device=None,
                 **overrides):
        if config is None:
            config = GenerateConfig(**overrides)
        elif overrides:
            raise MXNetError("GenerateSession: pass either config or "
                             "kwargs, not both")
        if not isinstance(model, GenerateModel):
            model = load_artifact(model, device=device)
            if not isinstance(model, GenerateModel):
                raise MXNetError(
                    "GenerateSession needs a generate artifact "
                    "(format_version 3 or 5); this is a predict artifact: "
                    "serve it with Server instead")
        self.model = model
        self.spec = model.spec
        self.config = config
        spec = self.spec
        # ONE prefill bucket == max_slots: every group size runs the same
        # shapes, the precondition of batch-independent tokens
        if model.prefill.buckets != (spec.max_slots,):
            model.prefill.set_buckets((spec.max_slots,),
                                      warmup=config.warmup)
        self._decode = model.decode
        self._commit = model.commit
        self.chunked = model.has_chunk_prefill
        self._chunk_prefill = model.chunk_prefill
        want = config.speculative
        if want and not model.speculative:
            raise MXNetError(
                "GenerateSession: speculative=True but the artifact "
                "bundles no draft; re-export with export_generate(..., "
                "draft_params=quantize_decoder_params(params)) or drop "
                "speculative=")
        self.speculative = (model.speculative if want is None
                            else bool(want))
        self.speculate_k = model.speculate_k if self.speculative else 0
        self.device = model.device
        self.cache = PagedKVCache(spec, self.device)
        if self.speculative:
            # the draft cache mirrors the verifier cache's geometry and
            # SHARES its page accounting: only the tensors are doubled
            self._draft_k = torch.zeros_like(self.cache.k)
            self._draft_v = torch.zeros_like(self.cache.v)
        self.d2h_copies = 0
        self.metrics_ = DecodeMetrics()
        S = spec.max_slots
        self._slots = [None] * S
        self._positions = _np.zeros(S, _np.int32)
        self._block = _np.zeros((S, spec.max_pages_per_slot), _np.int32)
        self._temps = _np.zeros(S, _np.float32)
        self._seeds = _np.zeros(S, _np.int32)
        self._cur = _np.zeros(S, _np.int32)
        self._pending = deque()
        self._cond = threading.Condition()
        self._accepting = True
        self._draining = False
        self._drain_budget = None
        self._closed = threading.Event()
        self._thread = None
        # metrics window accumulators (host scalars only)
        self._win_steps = 0
        self._win_tokens = 0
        self._win_spec_steps = 0
        self._win_drafted = 0
        self._win_accepted = 0
        # run every program once before traffic by default (flag-
        # controlled, like the predict path's engine warmup), so the
        # first request does not pay the kernel builds against its own
        # deadline
        do_warmup = (flags.serve_warmup if config.warmup is None
                     else bool(config.warmup))
        if do_warmup:
            self.warmup()
        if auto_start:
            self.start()

    # -- cost model --------------------------------------------------------
    def _param_count(self):
        s = self.spec
        return (12 * s.num_layers * s.dim * s.dim
                + 2 * s.vocab * s.dim + s.max_context * s.dim)

    def estimate_step_s(self):
        """Roofline estimate of one decode step: the weights read once,
        every slot's full context of K and V, 2 flops per parameter per
        slot. Drives retry-after and drain budgets."""
        s = self.spec
        n_par = self._param_count()
        flops = 2.0 * n_par * s.max_slots
        kv_bytes = 2.0 * s.num_layers * s.max_context * s.dim * 4 \
            * s.max_slots
        return max(roofline_seconds(flops, 4.0 * n_par + kv_bytes), 1e-6)

    def _retry_after(self):
        with self._cond:
            return self._retry_after_unlocked()

    def _retry_after_unlocked(self):
        backlog = sum(r.max_new_tokens for r in self._pending)
        backlog += sum(max(0, s.req.max_new_tokens - len(s.gen))
                       for s in self._slots if s is not None)
        rate = self.spec.max_slots / self.estimate_step_s()
        return max(0.005, backlog / rate)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="mxtorch-decode-sched",
                                            daemon=True)
            self._thread.start()
        return self

    @property
    def draining(self):
        return self._draining and not self._closed.is_set()

    @property
    def closed(self):
        return self._closed.is_set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self.closed:
            self.close(drain=True)

    def warmup(self):
        """Run every program once before traffic: one all-zeros prefill
        through the bucket engine, a zero-row commit of its K/V rows
        (scratch page only), one all-scratch decode step and, for a
        chunk-capable artifact, one zero-length chunk; when speculating,
        one zero-length draft chunk and one all-scratch speculative
        step. No live slot is touched and nothing is read back."""
        spec = self.spec
        S = spec.max_slots
        with torch.inference_mode():
            _first, k_rows, v_rows = self.model.prefill(
                _np.zeros((S, spec.max_prompt_len), _np.int32),
                _np.zeros(S, _np.int32), _np.zeros(S, _np.float32),
                _np.zeros(S, _np.int32))
            self._commit(self.cache.k, self.cache.v, k_rows[0], v_rows[0],
                         _np.zeros(spec.prompt_pages, _np.int32), 0)
            self._decode(self._cur[:, None], self._positions, self._block,
                         self._temps, self._seeds, self.cache.k,
                         self.cache.v)
            chunk_args = (_np.zeros(spec.max_prompt_len, _np.int32), 0, 0,
                          _np.zeros(spec.max_pages_per_slot, _np.int32),
                          0.0, 0)
            if self._chunk_prefill is not None:
                self._chunk_prefill(*chunk_args, self.cache.k, self.cache.v)
            if self.speculative:
                self.model.draft_chunk_prefill(*chunk_args, self._draft_k,
                                               self._draft_v)
                self.model.draft_verify(
                    self._cur[:, None], self._positions, self._block,
                    self._temps, self._seeds, self.cache.k, self.cache.v,
                    self._draft_k, self._draft_v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def close(self, drain=True, timeout=None):
        """Shut down. ``drain=True``: stop admitting, let every ACTIVE
        sequence produce at most ``drain_tokens`` more tokens, evict
        past the budget with a resumable cursor; queued-unstarted
        requests are evicted immediately (they lose nothing). ``drain=
        False``: evict everything now (drain budget 0, queued requests
        fail with ServerClosed)."""
        if self._closed.is_set():
            return
        with self._cond:
            self._accepting = False
            self._draining = True
            self._drain_budget = max(0, self.config.drain_tokens) \
                if drain else 0
            pending, self._pending = list(self._pending), deque()
            self._cond.notify_all()
        retry = self._retry_after()
        for r in pending:
            if drain:
                r._fail(Evicted(
                    "serve: draining; request evicted before prefill "
                    "(resubmit the cursor to run it)", tokens=[],
                    cursor=self._cursor(r, []), retry_after=retry))
                self.metrics_.note_evict()
            else:
                r._fail(ServerClosed("serve: server closed before this "
                                     "request was dispatched"))
        # bounded drain: longest surviving budget * modelled step time,
        # with generous slack, then the hard flag cap
        budget = timeout
        if budget is None:
            steps = self._drain_budget + 1
            budget = min(self.config.drain_timeout_s,
                         max(5.0, steps * self.estimate_step_s() * 50))
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(budget)
            if self._thread.is_alive():
                raise MXNetError(
                    "serve: decode drain did not finish within %.1fs "
                    "(%d slot(s) still live)"
                    % (budget, sum(1 for s in self._slots
                                   if s is not None)))
        else:
            t_end = time.monotonic() + budget
            while any(s is not None for s in self._slots):
                if time.monotonic() > t_end:
                    raise MXNetError(
                        "serve: inline decode drain did not finish "
                        "within %.1fs" % budget)
                self.run_round()
        self._publish_window(force=True)
        self._closed.set()

    # -- request path ------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               seed=0, timeout_ms=None):
        """Admit one generation; never blocks. Raises ServerBusy (queue
        full, with a cost-model retry-after), ServerClosed, or
        MXNetError (prompt/budget exceeds the artifact geometry)."""
        spec = self.spec
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        max_new_tokens = max(1, int(max_new_tokens))
        prompt = [int(t) for t in prompt]
        # chunked prefill (format_version 5) streams prompts longer than
        # max_prompt_len through fixed-shape chunks; without it the
        # prefill pad length is a hard cap
        cap = (spec.max_context if self.chunked else spec.max_prompt_len)
        if not 1 <= len(prompt) <= cap:
            raise MXNetError(
                "generate: prompt length %d outside [1, %d] (the "
                "artifact's %s)"
                % (len(prompt), cap,
                   "max_context: even chunked prefill cannot exceed "
                   "the paged-cache geometry" if self.chunked
                   else "max_prompt_len"))
        if len(prompt) + max_new_tokens > spec.max_context:
            raise MXNetError(
                "generate: prompt %d + max_new_tokens %d exceeds "
                "max_context %d (page_size %d * max_pages_per_slot %d)"
                % (len(prompt), max_new_tokens, spec.max_context,
                   spec.page_size, spec.max_pages_per_slot))
        if timeout_ms is None:
            timeout_ms = self.config.timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms and timeout_ms > 0 else None)
        req = GenerateRequest(prompt, max_new_tokens, temperature, seed,
                              deadline)
        with self._cond:
            if not self._accepting:
                raise ServerClosed(
                    "serve: generate session is shut down")
            depth = self.config.queue_depth
            if depth > 0 and len(self._pending) >= depth:
                retry = self._retry_after_unlocked()
                self.metrics_.note_reject()
                raise ServerBusy(
                    "serve: generation queue full (%d queued, depth %d); "
                    "retry after %.3fs" % (len(self._pending), depth,
                                           retry), retry_after=retry)
            self._pending.append(req)
            self._cond.notify()
        self.metrics_.note_submit()
        return req

    def generate(self, prompt, max_new_tokens=None, temperature=0.0,
                 seed=0, timeout_ms=None):
        """Blocking convenience: submit + result."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, seed=seed,
                          timeout_ms=timeout_ms)
        budget = (None if req.deadline is None
                  else max(0.001, req.deadline - time.monotonic()) + 30.0)
        return req.result(timeout=budget)

    # -- scheduler round ---------------------------------------------------
    def run_round(self):
        """One scheduler round: evict expired slots, admit + prefill a
        group into free slots, run one decode step for the live slots.
        Returns the number of scheduling events (admissions + evictions
        + steps); 0 means there was nothing to do."""
        with torch.inference_mode():
            events = self._evict_expired()
            events += self._admit()
            events += self._step()
        return events

    def _loop(self):
        with torch.inference_mode():
            while True:
                try:
                    worked = self.run_round()
                except Exception as e:  # noqa: BLE001 - the loop survives
                    # a round that raised fails the sequences it held
                    self._fail_live(e)
                    worked = 1
                with self._cond:
                    if (self._draining and not self._pending
                            and all(s is None for s in self._slots)):
                        break
                    if not worked and not self._pending:
                        self._cond.wait(0.002)

    # -- internals ---------------------------------------------------------
    def _cursor(self, req, gen):
        """The resumable cursor an evicted caller resubmits: the prompt
        for a continuation is prompt + everything generated so far."""
        return {"prompt": list(req.prompt), "generated": list(gen),
                "resume_prompt": list(req.prompt) + list(gen),
                "remaining_tokens": max(0, req.max_new_tokens - len(gen))}

    def _to_host(self, t):
        """The one way a device result reaches the host: a counted
        device-to-host copy."""
        self.d2h_copies += 1
        return t.cpu().numpy()

    def _release_slot(self, i):
        slot = self._slots[i]
        self._slots[i] = None
        self.cache.free(slot.pages)
        self._positions[i] = 0
        self._block[i, :] = 0
        self._temps[i] = 0.0
        self._seeds[i] = 0
        self._cur[i] = 0
        return slot

    def _fail_live(self, exc):
        """Fail every seated sequence with ``exc`` (its cause chained) and
        free its slot: a device error must reach the callers, not leave
        them waiting."""
        err = exc if isinstance(exc, MXNetError) else MXNetError(
            "%s: %s" % (type(exc).__name__, exc))
        if err is not exc:
            err.__cause__ = exc
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._release_slot(i)
                slot.req._fail(err)

    def _evict(self, i, why, expired=False):
        slot = self._release_slot(i)
        req = slot.req
        self.metrics_.note_evict(expired=expired)
        req._fail(Evicted(
            "serve: generation evicted mid-decode (%s) after %d token(s);"
            " resubmit cursor['resume_prompt'] to continue"
            % (why, len(slot.gen)), tokens=slot.gen,
            cursor=self._cursor(req, slot.gen),
            retry_after=self._retry_after()))

    def _finish(self, i, reason):
        slot = self._release_slot(i)
        req = slot.req
        now = time.monotonic()
        tpot = None
        if slot.t_first is not None and len(slot.gen) > 1:
            tpot = (now - slot.t_first) * 1e3 / (len(slot.gen) - 1)
        self.metrics_.note_complete(tpot_ms=tpot)
        out = {
            "tokens": list(slot.gen),
            "finish_reason": reason,
            "ttft_ms": req.ttft_ms,
            "tpot_ms": tpot,
            "latency_ms": (now - req.t_submit) * 1e3,
        }
        if self.speculative and slot.spec_steps:
            # per-request speculation health, from host counts
            out["accepted_tokens_per_step"] = round(
                (slot.accepted + slot.spec_steps)
                / float(slot.spec_steps), 4)
            out["draft_acceptance_rate"] = round(
                slot.accepted
                / float(slot.spec_steps * max(1, self.speculate_k)), 4)
        req._complete(out)

    def _evict_expired(self):
        now = time.monotonic()
        n = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req = slot.req
            if req.deadline is not None and now > req.deadline:
                self._evict(i, "deadline expired", expired=True)
                n += 1
            elif (self._draining and slot.drain_cap is not None
                  and len(slot.gen) >= slot.drain_cap):
                self._evict(i, "drain token budget (%d) reached"
                            % self._drain_budget)
                n += 1
        if self._draining:
            for slot in self._slots:
                if slot is not None and slot.drain_cap is None:
                    slot.drain_cap = len(slot.gen) + self._drain_budget
        return n

    def _take_admissible(self):
        """Pop the FIFO prefix that fits free slots + free pages; expire
        stale queued requests on the way. Head-of-line blocking on pages
        is deliberate: skipping ahead would starve big requests."""
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        if self.config.continuous:
            capacity = len(free_slots)
        else:
            # static baseline: only admit a full fresh group
            capacity = len(free_slots) if all(
                s is None for s in self._slots) else 0
        group = []
        now = time.monotonic()
        with self._cond:
            while self._pending and len(group) < capacity:
                req = self._pending[0]
                if req.deadline is not None and now > req.deadline:
                    self._pending.popleft()
                    self.metrics_.note_evict(expired=True)
                    req._fail(DeadlineExceeded(
                        "serve: deadline passed %.1fms before prefill"
                        % ((now - req.deadline) * 1e3)))
                    continue
                # the speculative window writes up to speculate_k rows
                # past the last emitted position: reserve pages for them
                # so a full cache cannot make a step write into another
                # sequence's pages (capped at max_context: rows past it
                # go to scratch)
                need = self.cache.pages_needed(
                    min(len(req.prompt) + req.max_new_tokens
                        + self.speculate_k, self.spec.max_context))
                if need > self.cache.free_pages:
                    break
                self._pending.popleft()
                pages = self.cache.alloc(need)
                group.append((free_slots[len(group)], req, pages))
        return group

    def _admit(self):
        group = self._take_admissible()
        if not group:
            return 0
        try:
            self._prefill_group(group)
        except Exception as e:
            # the members not seated yet hold pages but no slot: fail
            # them here (the seated ones fail with the round)
            for i, req, pages in group:
                seated = (self._slots[i] is not None
                          and self._slots[i].req is req)
                if not seated and not req.done():
                    self.cache.free(pages)
                    req._fail(MXNetError("generate: prefill failed: %s: %s"
                                         % (type(e).__name__, e)))
            raise
        return len(group)

    def _prefill_group(self, group):
        spec = self.spec
        P = spec.max_prompt_len
        short = [e for e in group if len(e[1].prompt) <= P]
        # prompts past the prefill pad stream through chunk_prefill
        # (submit() only lets them in on a chunk-capable artifact)
        long = [e for e in group if len(e[1].prompt) > P]
        if short:
            g = len(short)
            # host-side pad to the FIXED slot count: every prefill has
            # identical shapes; rows past g are inert scratch work
            S = spec.max_slots
            tokens = _np.zeros((S, P), _np.int32)
            lengths = _np.zeros(S, _np.int32)
            temps = _np.zeros(S, _np.float32)
            seeds = _np.zeros(S, _np.int32)
            for j, (_, req, _pages) in enumerate(short):
                lengths[j] = len(req.prompt)
                tokens[j, :len(req.prompt)] = req.prompt
                temps[j] = req.temperature
                seeds[j] = req.seed
            first, k_rows, v_rows = self.model.prefill(tokens, lengths,
                                                       temps, seeds)
            # the ONE device-to-host copy for this prefill group
            first_host = self._to_host(first)
            self.metrics_.note_prefill(g)
            t_now = time.monotonic()
            for j, (i, req, pages) in enumerate(short):
                plen = len(req.prompt)
                page_ids = _np.zeros(spec.prompt_pages, _np.int32)
                n_prompt_pages = self.cache.pages_needed(plen)
                page_ids[:n_prompt_pages] = pages[:n_prompt_pages]
                self._commit(self.cache.k, self.cache.v, k_rows[j],
                             v_rows[j], page_ids, plen)
                self._activate(i, req, pages, int(first_host[j]), t_now)
        for (i, req, pages) in long:
            self._admit_chunked(i, req, pages)

    def _chunk_args(self, req, block_row):
        """The fixed-shape chunks of ``req``'s prompt as the leading
        arguments of a chunk prefill: (tokens, start, n, block table,
        temperature, seed)."""
        P = self.spec.max_prompt_len
        bt = torch.as_tensor(block_row, device=self.device)
        for start in range(0, len(req.prompt), P):
            chunk = req.prompt[start:start + P]
            toks = _np.zeros(P, _np.int32)
            toks[:len(chunk)] = chunk
            yield toks, start, len(chunk), bt, req.temperature, req.seed

    def _admit_chunked(self, i, req, pages):
        """Stream one long prompt through fixed-shape ``chunk_prefill``
        runs straight into the paged cache (the draft cache rides the
        same loop when speculating). ONE device-to-host copy for the
        whole prompt: the FINAL chunk's sampled token."""
        row = _np.zeros(self.spec.max_pages_per_slot, _np.int32)
        row[:len(pages)] = pages
        for args in self._chunk_args(req, row):
            nxt, _k, _v = self._chunk_prefill(*args, self.cache.k,
                                              self.cache.v)
            if self.speculative:
                self.model.draft_chunk_prefill(*args, self._draft_k,
                                               self._draft_v)
        tok = int(self._to_host(nxt))
        self.metrics_.note_prefill(1)
        self._activate(i, req, pages, tok, time.monotonic(),
                       need_draft=False)

    def _activate(self, i, req, pages, tok, t_now, need_draft=True):
        """Post-prefill slot activation shared by the batched and
        chunked paths: record TTFT, seat the slot, then either finish
        at once or arm the decode-step host state (and, on a
        speculative session, fill the draft cache unless the chunked
        path already did)."""
        spec = self.spec
        req.ttft_ms = (t_now - req.t_submit) * 1e3
        self.metrics_.note_ttft(req.ttft_ms)
        slot = _Slot(req, pages)
        slot.gen.append(tok)
        slot.t_first = t_now
        self._slots[i] = slot
        self._win_tokens += 1
        if self._draining:
            slot.drain_cap = len(slot.gen) + self._drain_budget
        if spec.eos_id >= 0 and tok == spec.eos_id:
            self._finish(i, "stop")
        elif req.max_new_tokens <= 1:
            self._finish(i, "length")
        else:
            self._block[i, :] = 0
            self._block[i, :len(pages)] = pages
            self._positions[i] = len(req.prompt)  # where `tok` lands
            self._temps[i] = req.temperature
            self._seeds[i] = req.seed
            self._cur[i] = tok
            if self.speculative and need_draft:
                # the draft cache gets the prompt's int8 K/V rows; the
                # draft chunks' sampled tokens stay on the device, unread
                for args in self._chunk_args(req, self._block[i].copy()):
                    self.model.draft_chunk_prefill(*args, self._draft_k,
                                                   self._draft_v)

    def _step(self):
        """One decode step for every live slot: ``decode`` (one token a
        slot) or, speculating, ``draft_verify``, whose packed ``(S,
        k+2)`` int32 rows ``[n_accept, v_1 .. v_{k+1}]`` emit ``v_1 ..
        v_{n_accept+1}``. Either way the ONE device-to-host copy of the
        step is its result."""
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        state = (self._cur[:, None], self._positions, self._block,
                 self._temps, self._seeds, self.cache.k, self.cache.v)
        if self.speculative:
            packed = self.model.draft_verify(*state, self._draft_k,
                                             self._draft_v)[0]
            host = self._to_host(packed)
            cands = [host[i, 1:2 + host[i, 0]] for i in active]
        else:
            host = self._to_host(self._decode(*state)[0])
            cands = [host[i:i + 1] for i in active]
        for i, cand in zip(active, cands):
            self._emit(i, cand)
        self._win_steps += 1
        if self._win_steps >= max(1, self.config.window_steps):
            self._publish_window()
        return 1

    def _emit(self, i, cand):
        """Append one step's candidate tokens to slot ``i``, cut at the
        token budget and at EOS, and finish the slot when it is done."""
        slot = self._slots[i]
        eos = self.spec.eos_id
        budget = slot.req.max_new_tokens - len(slot.gen)
        emitted = []
        for t in cand:
            emitted.append(int(t))
            if (eos >= 0 and emitted[-1] == eos) or len(emitted) >= budget:
                break
        slot.gen.extend(emitted)
        self._positions[i] += len(emitted)
        self._cur[i] = emitted[-1]
        self._win_tokens += len(emitted)
        if self.speculative:
            slot.spec_steps += 1
            slot.accepted += len(emitted) - 1
            self._win_spec_steps += 1
            self._win_drafted += self.speculate_k
            self._win_accepted += len(emitted) - 1
        if eos >= 0 and emitted[-1] == eos:
            self._finish(i, "stop")
        elif len(slot.gen) >= slot.req.max_new_tokens:
            self._finish(i, "length")

    def _publish_window(self, force=False):
        if not force and self._win_steps == 0:
            return
        self.metrics_.publish_window(steps=self._win_steps,
                                     tokens=self._win_tokens,
                                     spec_steps=self._win_spec_steps,
                                     drafted=self._win_drafted,
                                     accepted=self._win_accepted)
        self._win_steps = 0
        self._win_tokens = 0
        self._win_spec_steps = 0
        self._win_drafted = 0
        self._win_accepted = 0

    # -- observability -----------------------------------------------------
    def metrics(self):
        snap = self.metrics_.snapshot()
        with self._cond:
            snap["queue"] = {"depth": len(self._pending)}
        snap["slots"] = {
            "max": self.spec.max_slots,
            "active": sum(1 for s in self._slots if s is not None),
        }
        snap["kv_pages"] = {
            "total": self.cache.total_pages,
            "free": self.cache.free_pages,
            "occupancy": round(self.cache.occupancy(), 4),
            "page_size": self.spec.page_size,
        }
        snap["estimated_step_s"] = self.estimate_step_s()
        if self.speculative:
            snap["speculative"]["k"] = self.speculate_k
        snap["engines"] = (self.model.prefill.engine_cache.stats()
                           if self.model.prefill.engine_cache else None)
        snap["status"] = ("closed" if self.closed
                          else "draining" if self.draining else "ok")
        return snap

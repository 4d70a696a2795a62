"""Continuous batching scheduler (vLLM-style slot machine).

Counterpart of ``repro.serving.scheduler``.  A fixed batch of decode slots
advances in lockstep through one serve step per tick; requests of ragged
lengths stream through the slots:

  * admit  -- a free slot takes the next queued request; the slot's rows
    of every cache leaf with a batch axis are reset from a pristine
    template along that declared axis (its idx -> 0, a hybrid's Mamba2
    conv and SSM state -> zeros, an xlstm's mLSTM and sLSTM state -> zeros
    and its stabiliser m -> -1e30), so no state leaks across tenants;
  * prefill -- the prompt is teacher-forced through the decode step
    (``prefill_chunk`` tokens a tick via the masked chunk step, or one a
    tick -- numerically identical either way);
  * decode -- the greedy token feeds back until ``max_new_tokens`` or EOS,
    then the slot retires and re-admits.

KV memory (``kv_cache="paged"``): attention KV lives in a shared page pool
(``serving.paged_cache``); slots hold pages only for positions they have
written, admission applies backpressure when the pool cannot cover a
prompt, and a decoding slot that needs a page may preempt a prefilling one.
The victim is requeued and replayed: greedy decode makes the replay
token-identical, so preemption is invisible in the output stream.

Decisions of the port:

  * **Slot packing.**  The physical slot count comes from the rmsnorm plan
    of the decode batch, as in the reference; the port's planner has row
    unit 1, so ``padded_slots == slots`` (the reference pads to a sublane
    tile, so its cache shapes differ; the parity tests compare tokens and
    logits, never cache shapes).
  * **In place.**  The cache tensors are updated in place (slot resets,
    page-table rows, the KV writes of ``models.blocks``); the template of
    pristine rows is a copy.
  * **Inference mode.**  Everything that touches tensors runs under
    ``torch.inference_mode()``.
  * **Device.**  The cache is made on ``device`` (CUDA unless named), which
    must be where the parameters are.
  * **No encoder-decoder.**  An encdec model raises: the reference's
    batcher never calls ``prefill_cross``, so it would decode against
    all-zero cross K/V (dense) or fail on the missing ``paged_cache_defs``
    (ROADMAP §C); ``launch.serve`` serves it as a static batch.
  * **Events.**  Under an ``obs`` session the batcher streams the
    reference's events: an ``AdmissionEvent`` an admission, a
    ``PreemptionEvent`` an eviction, a ``BatcherTickEvent`` (and, paged, a
    ``PagePoolEvent``) a tick, a ``DegradedEvent`` a pool shrink and a
    ``RequestAbandonedEvent`` for each request a tick budget cuts off.
    ``preemption_log`` keeps the ``(rid, reason)`` of each eviction as
    well.  On a mesh every rank runs the same schedule, so rank 0's stream
    is the run's (only rank 0 opens a sink, ``obs.bus``).

On a mesh (``mesh=``, as the reference's batcher takes it; or the ambient
mesh of ranks): the slot and page plans are made under the mesh, and on a
``launch.mesh.Mesh`` of more than one rank every rank runs the same host
schedule over the *global* slots -- admission, pages, preemption, EOS --
while its device tensors are its block of the cache
(``parallel.specs.cache_specs`` under the rules: the ambient ones, else
``rules.decode_rules(cfg, mesh)``): its rows of the slots, its KV heads,
its recurrent heads and columns.  A slot's reset, page-table writes and
feed touch only the rank that holds its row.  After each device call the
next tokens (``slots / D`` int32 a rank) are all-gathered over the data
axes, so every rank's scheduler sees every slot's token and takes the same
decision; no decision reads a rank-local tensor.  The chunk step is told
the global micro-step count.  Where the slots do not divide the data
ranks, every data rank holds every slot (the rules' "batch" whole).  The
paged pool has no batch axis and is whole over "data", as the reference's
spec leaves it: a rank writes and reads only its own slots' pages, so the
other ranks' pages in its copy are never read (cutting the pool by data
rank is memory work, ROADMAP A11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from collections import deque
from typing import Iterable

import numpy as np
import torch

from repro_torch import api, obs
from repro_torch.kernels.util import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.parallel import rules as rules_lib
from repro_torch.parallel import specs as specs_lib
from repro_torch.parallel import steps as steps_lib
from repro_torch.serving.paged_cache import PageManager, plan_page_geometry

log = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    fed: int = 0                      # replay tokens fed so far
    restart_target: int = 0           # replay horizon after a preemption
    preemptions: int = 0

    @property
    def replay_len(self) -> int:
        """Tokens to teacher-force before new decoding starts: the prompt,
        or -- after a preemption -- the prompt plus everything generated."""
        return max(len(self.prompt), self.restart_target)

    def replay_token(self, i: int) -> int:
        p = len(self.prompt)
        return self.prompt[i] if i < p else self.generated[i - p]

    @property
    def prefilling(self) -> bool:
        return self.fed < self.replay_len

    def done(self, eos_id: int | None) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(
            eos_id is not None and self.generated
            and self.generated[-1] == eos_id
        )


class TruncatedRun(RuntimeError):
    """``run()`` hit ``max_ticks`` with work still in flight.

    ``completed`` holds every finished request's tokens; ``abandoned`` the
    unfinished ``Request`` objects, their partial state intact."""

    def __init__(self, completed: dict[int, list[int]],
                 abandoned: list[Request], max_ticks: int):
        self.completed = completed
        self.abandoned = abandoned
        rids = [r.rid for r in abandoned]
        super().__init__(
            f"run() exhausted max_ticks={max_ticks} with "
            f"{len(abandoned)} request(s) unfinished (rids {rids}); "
            f"{len(completed)} completed. Pass on_truncation='return' to "
            f"accept partial results (check .busy afterwards).")


def _first_device(tree) -> torch.device | None:
    for _, leaf in params_lib.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class ContinuousBatcher:
    @torch.inference_mode()
    def __init__(self, model, params, *, slots: int, max_len: int,
                 eos_id: int | None = None, seed: int = 0,
                 mesh=None, kv_cache: str = "dense",
                 page_len: int | None = None, n_pages: int | None = None,
                 page_banks: int = 4, prefill_chunk: int = 1, device=None):
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f"kv_cache must be 'dense' or 'paged', "
                             f"got {kv_cache!r}")
        cfg = getattr(model, "cfg", None)
        if getattr(cfg, "family", None) == "encdec":
            raise ValueError(
                f"{cfg.name}: the continuous batcher does not serve an "
                f"encoder-decoder (it never fills the cross K/V); serve it "
                f"on the static-batch path of launch.serve (prefill_cross, "
                f"then make_decode_step)")
        self.device = resolve_device(device)
        pdev = _first_device(params)
        if pdev is not None:
            if pdev.type != self.device.type:
                raise ValueError(f"parameters are on {pdev}, the batcher "
                                 f"runs on {self.device}")
            self.device = pdev
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.kv_cache = kv_cache
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._d_model = int(getattr(cfg, "d_model", 0))
        self._adtype = getattr(cfg, "adtype", torch.float32)
        # An explicit mesh wins for planning; otherwise the ambient
        # plan_context is consulted at each planning call
        self.mesh = mesh
        self.decode_plan = self._batch_plan(slots)
        self.padded_slots = (
            self.decode_plan.rows if self.decode_plan is not None else slots)
        self.plans: dict[tuple[str, int], object] = {}
        if kv_cache == "paged":
            self.geometry, self.page_plan = plan_page_geometry(
                cfg, max_len, page_len=page_len, n_pages=n_pages,
                slots=slots, banks=page_banks, mesh=mesh)
            self.pages = PageManager(self.geometry, self.padded_slots)
            defs = model.paged_cache_defs(
                self.padded_slots, max_len,
                self.geometry.n_pages, self.geometry.page_len)
        else:
            self.geometry = self.page_plan = self.pages = None
            defs = model.cache_defs(self.padded_slots, max_len)
        # Per-leaf batch axis from the defs' declared logical axes (-1: no
        # batch axis, e.g. the shared paged KV pools) -- never guessed from
        # shapes, which collide when max_len equals padded_slots.
        self._batch_axes = params_lib.map_tree(
            lambda d: d.axes.index("batch") if "batch" in d.axes else -1,
            defs)
        self.decode = steps_lib.make_decode_step(model)
        self._chunk = steps_lib.make_chunk_step(model, self._batch_axes)
        self._place(cfg, defs)
        self.cache = params_lib.init_params(
            seed, defs, device=self.device,
            cut=None if self.ranks is None else specs_lib.leaf_cutter(
                self.cache_specs, self.ranks))
        # Pristine per-slot rows for admission resets; leaves with no batch
        # axis (shared pools) are never reset row-wise, so share storage.
        self._template = params_lib.map_leaves(
            lambda c, ax: c if ax < 0 else c.clone(),
            self.cache, self._batch_axes)
        self.slot_req: list[Request | None] = [None] * slots
        self._slot_pos = [0] * slots      # host mirror of each slot's idx
        self._slot_seq = [0] * slots      # admission order (for preemption)
        self._seq = 0
        self.queue: deque[Request] = deque()
        self.ticks = 0
        self.micro_steps = 0              # decode steps the model ran
        self.preemption_log: list[tuple[int, str]] = []   # (rid, reason)
        self.completed: dict[int, list[int]] = {}

    # ---- the mesh of ranks -------------------------------------------
    def _place(self, cfg, defs) -> None:
        """This rank's place on a mesh of ranks (``self.ranks``, ``None``
        on one device): the rules the device calls run under, the cache's
        specs, the data axes the slots are cut over and this rank's global
        slots ``[lo, hi)``."""
        ranks = self.mesh if self.mesh is not None else (
            rules_lib.current_mesh() or api.current_context().mesh)
        if not (hasattr(ranks, "all_gather") and ranks.size > 1):
            ranks = None
        self.ranks = ranks
        self.rules, self.cache_specs, self._data_axes = None, None, ()
        self._lo, self._hi = 0, self.padded_slots
        if ranks is None:
            return
        table = rules_lib.mesh_table(
            ranks, rules_lib.current_rules()
            or rules_lib.decode_rules(cfg, ranks))
        data = tuple(a for a in rules_lib.mesh_axes("batch", ranks, table)
                     if ranks.axis_size(a) > 1)
        if data and self.padded_slots % ranks.axis_size(data):
            # every data rank holds every slot
            table, data = {**table, "batch": None}, ()
        self.rules, self._data_axes = table, data
        self.cache_specs = specs_lib.cache_specs(defs, table,
                                                 ranks.axis_sizes)
        if self.geometry is not None and hasattr(self.model, "cache_defs"):
            # the paged view is read over the dense cache's split of its
            # positions (flash decoding): refuse, before any collective, a
            # page table whose positions that split does not divide
            g = self.geometry
            span = -(-self.max_len // g.page_len) * g.page_len
            specs_lib.cache_specs(self.model.cache_defs(self.padded_slots,
                                                        span),
                                  table, ranks.axis_sizes)
        rows = self.padded_slots // ranks.axis_size(data)
        self._lo = ranks.index(data) * rows
        self._hi = self._lo + rows

    def _scope(self):
        """The plan context and rules a device call runs under: this
        batcher's mesh of ranks, else nothing."""
        if self.ranks is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(api.plan_context(mesh=self.ranks))
        stack.enter_context(rules_lib.use_rules(self.rules, self.ranks))
        return stack

    def _row(self, slot: int) -> int | None:
        """This rank's row of global ``slot``, or ``None`` where another
        rank holds it."""
        return slot - self._lo if self._lo <= slot < self._hi else None

    # ---- layout planning ---------------------------------------------------
    def _batch_plan(self, rows: int):
        """Registry plan for a decode/prefill batch of ``rows`` sequences:
        the per-token norm kernel over (rows, d_model) under this batcher's
        mesh, else the ambient context's."""
        if not self._d_model or rows <= 0:
            return None
        ctx = api.current_context()
        if self.mesh is not None:
            ctx = ctx.evolve(mesh=self.mesh)
        return api.plan_for("rmsnorm", (rows, self._d_model), self._adtype,
                            ctx=ctx)

    def _note_admitted_plans(self) -> None:
        """Record the plans of the currently admitted batch shapes, keyed
        by (phase, occupied count); memoized by the planner."""
        n_prefill = sum(r is not None and r.prefilling for r in self.slot_req)
        n_decode = sum(r is not None and not r.prefilling
                       for r in self.slot_req)
        for phase, n in (("prefill", n_prefill), ("decode", n_decode)):
            if n:
                plan = self._batch_plan(n)
                if plan is not None:
                    self.plans[(phase, n)] = plan

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def submit(self, reqs: Iterable[Request]) -> None:
        for req in reqs:
            if not req.prompt:
                # An empty prompt has no token to feed and no position for
                # the first output -- reject it instead of failing mid-tick.
                raise ValueError(
                    f"request {req.rid}: empty prompt (serving needs at "
                    f"least one prompt token)")
            self.queue.append(req)
        self._admit()

    def _reset_slot(self, cache, slot: int):
        """Copy pristine template rows into ``slot`` for every cache leaf,
        in place, along each leaf's declared batch axis.  Leaves without a
        batch axis -- the shared paged KV pools -- are left alone; the
        zeroed page-table row already unmaps the slot.  On a mesh only the
        rank holding the slot's row writes it."""
        row = self._row(slot)
        if row is None:
            return cache

        def reset(c, t, ax):
            if ax >= 0:
                c.select(ax, row).copy_(t.select(ax, row))
            return c

        return params_lib.map_leaves(reset, cache, self._template,
                                     self._batch_axes)

    # ---- paged-pool bookkeeping --------------------------------------
    def _release_slot_pages(self, slot: int) -> list[int]:
        """Return ``slot``'s pages to the pool and unmap its device page
        table now -- idle slots still write every tick, and a stale table
        row would corrupt whoever the pages go to next."""
        freed = self.pages.release(slot)
        row = self._row(slot)
        if freed and row is not None:
            self.cache["pages"][row] = 0
        return freed

    def _preempt(self, victim: int, reason: str) -> int:
        """Evict ``victim``: pages back to the pool, request to the head of
        the queue with its replay horizon recorded.  Returns pages freed."""
        req = self.slot_req[victim]
        req.restart_target = len(req.prompt) + len(req.generated)
        req.fed = 0
        req.preemptions += 1
        freed = self._release_slot_pages(victim)
        self.slot_req[victim] = None
        self._slot_pos[victim] = 0
        self.queue.appendleft(req)
        self.preemption_log.append((req.rid, reason))
        if obs.enabled():
            obs.emit(obs.PreemptionEvent(
                rid=req.rid, slot=victim, reason=reason,
                pages_freed=len(freed), queue_depth=len(self.queue)))
        return len(freed)

    def _preempt_one(self, *, exclude: int, allow_decode: bool,
                     reason: str) -> bool:
        """Pick and evict one victim: prefilling slots first (newest
        admission first), then -- only for a decoding claimant -- the
        youngest decoding slot."""
        pre = [s for s, r in enumerate(self.slot_req)
               if r is not None and r.prefilling and s != exclude
               and self.pages.slot_pages(s)]
        if pre:
            self._preempt(max(pre, key=lambda s: self._slot_seq[s]), reason)
            return True
        if allow_decode:
            dec = [s for s, r in enumerate(self.slot_req)
                   if r is not None and not r.prefilling and s != exclude
                   and self.pages.slot_pages(s)]
            if dec:
                self._preempt(max(dec, key=lambda s: self._slot_seq[s]),
                              reason)
                return True
        return False

    def _ensure_pages(self, slot: int, upto_pos: int, *,
                      decoding: bool) -> bool:
        """Grow ``slot``'s page table to cover ``upto_pos``, preempting if
        the pool is dry.  A decoding slot may evict prefillers then younger
        decoders; a prefilling slot may only displace newer prefillers and
        otherwise stalls (returns False -- the tick skips it)."""
        reason = "decode_pressure" if decoding else "prefill_pressure"
        while True:
            got = self.pages.alloc(slot, upto_pos)
            if got is not None:
                row = self._row(slot)
                if got and row is not None:
                    lps, phys = zip(*got)
                    self.cache["pages"][row, list(lps)] = torch.tensor(
                        phys, dtype=torch.int32, device=self.device)
                return True
            if not self._preempt_one(exclude=slot, allow_decode=decoding,
                                     reason=reason):
                if decoding:
                    need = self.pages.needed(slot, upto_pos)
                    raise RuntimeError(
                        f"page pool too small: decoding slot {slot} needs "
                        f"{need} more page(s) of {self.geometry.page_len} "
                        f"with nothing left to preempt "
                        f"(n_pages={self.geometry.n_pages})")
                return False

    def _can_admit(self, req: Request) -> bool:
        """Paged admission backpressure: the pool must cover the request's
        replay plus one decode page, after reserving one growth page per
        already-decoding slot."""
        if self.pages is None:
            return True
        need = self.geometry.pages_for(min(req.replay_len + 1, self.max_len))
        if need > self.pages.live_pages:
            raise RuntimeError(
                f"page pool too small: request {req.rid} needs {need} "
                f"page(s) of {self.geometry.page_len} but the pool only "
                f"has {self.pages.live_pages} "
                f"(n_pages={self.geometry.n_pages})")
        reserve = sum(r is not None and not r.prefilling
                      for r in self.slot_req)
        return need + reserve <= self.pages.free_pages

    @torch.inference_mode()
    def shrink_pool(self, live_pages: int) -> int:
        """Graceful degradation on capacity loss: shrink the allocatable
        page pool to ``live_pages``, preempting tenants (decode included)
        through the replay path until enough pages are free to retire.
        Returns how many tenants were preempted."""
        if self.pages is None:
            raise RuntimeError(
                "shrink_pool requires kv_cache='paged' (a dense cache has "
                "no page pool to shrink)")
        before = self.pages.live_pages
        preempted = 0
        deficit = self.pages.shrink(live_pages)
        while deficit > 0:
            if not self._preempt_one(exclude=-1, allow_decode=True,
                                     reason="pool_shrink"):
                raise RuntimeError(
                    f"cannot shrink page pool to {live_pages} live "
                    f"page(s): {deficit} still to retire with no tenant "
                    f"left to preempt")
            preempted += 1
            deficit = self.pages.shrink(live_pages)
        log.warning("page pool shrunk %d -> %d live page(s); %d tenant(s) "
                    "preempted to the replay queue", before,
                    self.pages.live_pages, preempted)
        if obs.enabled():
            obs.emit(obs.DegradedEvent(
                reason="pool_shrink",
                detail=f"live pages {before} -> {self.pages.live_pages}, "
                       f"{preempted} tenant(s) preempted for replay"))
        return preempted

    def _admit(self) -> None:
        admitted = False
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                if not self._can_admit(self.queue[0]):
                    break        # FIFO: no head-of-line bypass
                req = self.queue.popleft()
                self.slot_req[s] = req
                self._slot_pos[s] = 0
                self._seq += 1
                self._slot_seq[s] = self._seq
                self.cache = self._reset_slot(self.cache, s)
                admitted = True
                if obs.enabled():
                    obs.emit(obs.AdmissionEvent(
                        rid=req.rid, slot=s, queue_depth=len(self.queue)))
        if admitted:
            self._note_admitted_plans()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        self._note_admitted_plans()
        width = 1
        if self.prefill_chunk > 1 and any(
                r is not None and r.prefilling for r in self.slot_req):
            width = self.prefill_chunk
        # Per-slot advance this tick; paged slots must hold pages for every
        # position they will write before the device call.  Decoders claim
        # first (decode priority), then prefillers oldest-first; a prefiller
        # that cannot get pages stalls (advance 0) this tick.
        advance = [0] * self.slots
        order = sorted(
            (s for s, r in enumerate(self.slot_req) if r is not None),
            key=lambda s: (self.slot_req[s].prefilling, self._slot_seq[s]))
        for s in order:
            req = self.slot_req[s]
            if req is None:       # evicted by an earlier claimant this tick
                continue
            n = (min(width, req.replay_len - req.fed) if req.prefilling
                 else 1)
            if self.pages is not None:
                upto = min(self._slot_pos[s] + n, self.max_len) - 1
                if not self._ensure_pages(s, upto,
                                          decoding=not req.prefilling):
                    continue
            advance[s] = n
        feed = np.zeros((self.padded_slots, width), np.int32)
        nvalid = np.zeros((self.padded_slots,), np.int32)
        for s, req in enumerate(self.slot_req):
            if req is None or not advance[s]:
                continue
            nvalid[s] = advance[s]
            if req.prefilling:
                for j in range(advance[s]):
                    feed[s, j] = req.replay_token(req.fed + j)
            else:
                feed[s, 0] = req.generated[-1]
        # The chunk step is only needed when rows advance unevenly (chunked
        # prefill, or a stalled slot under page pressure); the uniform case
        # keeps the single-token decode step.
        active = [n for n in advance if n]
        uniform = width == 1 and len(active) == sum(
            r is not None for r in self.slot_req)
        mine = slice(self._lo, self._hi)
        tokens = torch.from_numpy(feed[mine]).to(self.device)
        with self._scope():
            if uniform:
                nxt, self.cache = self.decode(self.params, self.cache,
                                              tokens)
                self.micro_steps += 1
            else:
                steps = int(nvalid.max())
                nxt, self.cache = self._chunk(
                    self.params, self.cache, tokens,
                    torch.from_numpy(nvalid[mine]).to(self.device), steps)
                self.micro_steps += steps
            if self._data_axes:
                nxt = self.ranks.all_gather(nxt, self._data_axes, 0)
        nxt = nxt[:, 0].cpu().numpy()
        self.ticks += 1
        if obs.enabled():
            self._emit_tick()
        for s, req in enumerate(self.slot_req):
            if req is None or not advance[s]:
                continue
            self._slot_pos[s] += advance[s]
            if req.prefilling:
                req.fed += advance[s]
                if not req.prefilling:      # replay boundary: first new token
                    req.generated.append(int(nxt[s]))
            else:
                req.generated.append(int(nxt[s]))
            if req.done(self.eos_id):
                self.completed[req.rid] = req.generated[: req.max_new_tokens]
                self.slot_req[s] = None
                self._slot_pos[s] = 0
                if self.pages is not None:
                    self._release_slot_pages(s)
        self._admit()

    def _emit_tick(self) -> None:
        """The tick's occupancy and packing: free slots and tile padding
        (``padded_slots - slots``, 0 in the port) run through the decode
        step serving no request; paged, the pool's occupancy too."""
        n_prefill = sum(r is not None and r.prefilling for r in self.slot_req)
        n_decode = sum(r is not None and not r.prefilling
                       for r in self.slot_req)
        obs.emit(obs.BatcherTickEvent(
            tick=self.ticks, n_prefill=n_prefill, n_decode=n_decode,
            slots=self.slots, padded_slots=self.padded_slots,
            free_slots=self.slots - n_prefill - n_decode,
            pad_slots=self.padded_slots - self.slots,
            queue_depth=len(self.queue)))
        if self.pages is not None:
            obs.emit(obs.PagePoolEvent(
                tick=self.ticks, used_pages=self.pages.used_pages,
                free_pages=self.pages.free_pages,
                live_pages=self.pages.live_pages,
                page_len=self.geometry.page_len))

    @torch.inference_mode()
    def decode_tick(self) -> torch.Tensor:
        """One decode step of every slot outside the schedule, each fed
        token 1: a full tick's device work (to profile or warm it), no
        request advanced and nothing counted; on a mesh every rank must
        call it.  Returns this rank's rows' next tokens."""
        feed = torch.ones((self._hi - self._lo, 1), dtype=torch.int32,
                          device=self.device)
        with self._scope():
            nxt, self.cache = self.decode(self.params, self.cache, feed)
        return nxt

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    @torch.inference_mode()
    def run(self, reqs: Iterable[Request], *, max_ticks: int = 100_000,
            on_truncation: str = "raise",
            fault_injector=None) -> dict[int, list[int]]:
        """Drive submitted requests to completion (or ``max_ticks``).

        Hitting the tick budget with work in flight is never silent: the
        default raises :class:`TruncatedRun`; ``on_truncation='return'``
        returns the partial ``completed`` dict (check ``self.busy``).
        Either way each abandoned request is reported on the obs bus.
        ``fault_injector`` is any object with ``tick(batcher, tick)``,
        consulted before each tick (the reference's
        ``runtime.faults.FaultInjector``, whose port waits for ROADMAP A12).
        """
        if on_truncation not in ("raise", "return"):
            raise ValueError(
                f"on_truncation must be 'raise' or 'return', "
                f"got {on_truncation!r}")
        self.submit(reqs)
        while self.busy and self.ticks < max_ticks:
            if fault_injector is not None:
                fault_injector.tick(self, self.ticks)
            self.step()
        if self.busy:
            abandoned = [r for r in self.slot_req if r is not None]
            abandoned += list(self.queue)
            if obs.enabled():
                for r in abandoned:
                    stage = ("queued" if r in self.queue
                             else "prefill" if r.prefilling else "decode")
                    obs.emit(obs.RequestAbandonedEvent(
                        rid=r.rid, stage=stage, fed=r.fed,
                        generated=len(r.generated)))
            if on_truncation == "raise":
                raise TruncatedRun(dict(self.completed), abandoned,
                                   max_ticks)
        return self.completed

"""Continuous batching over a shared physical page pool (counterpart of
``quest_tpu/engine/scheduler.py``, whose host logic it keeps).

  * The paged cache has ``max_batch`` **slots** with independent
    ``seq_lens``. Slots map logical pages onto the SHARED physical pool
    through their block-table rows (kv/paged_kv.py), so the pool's
    capacity is ``total_pages``, independent of max_batch x max_seq_len.
  * Physical blocks are owned through :class:`~quest_tpu_torch.kv.pool.
    PagePool` at ``block_pages``-page granularity. A request's whole need (prompt + max_new_tokens) is
    reserved at admission, so an admitted request never meets an
    exhausted pool; admission is FIFO and waits while blocks are short.
  * **Chunked prefill**: prompts are written in ``prefill_chunk``-token
    chunks, a prefill tick alternating with a decode burst, so a long
    prompt never stalls the decoding streams. A prefill tick computes
    only the prefilling slots' rows, through a view of the cache that
    holds those rows (``PagedKVCache.rows``); a decode burst runs all
    ``max_batch`` rows, busy rows riding along with ``active = False``
    and writing into the scratch block 0.
  * **Prefix cache**: the full blocks of a completed prompt are
    published under a blake2b chain of their tokens, LRU-capped; a
    later prompt with the same leading blocks borrows them (refcounted)
    and prefills only the rest. The min/max metadata is keyed by
    physical block, so borrowing is host bookkeeping only.
  * Finished slots release their blocks and reset their table row to
    scratch and their length to 0.
  * **Window layers** (``SparseWindowConfig.layer_types``) keep a
    second cache (``cache.window``, kv/paged_kv.py) with a block pool of
    its own: a slot holds only the window blocks that its next tick's
    queries can see, mapped before the tick as the slot reaches them and
    released once its window has passed them, so a slot holds a bounded
    number of them whatever its length. A published prompt's entry for
    its last full block also keeps the window blocks that end there
    (LRU-capped apart from the registry); a later prompt borrows a prefix
    only at a boundary with that state, backing off to the longest one
    that has it, and aliases those window blocks into its window table.

Decoding runs in **bursts**: ``burst`` chained steps on the device (the
greedy step's argmax, or the sampled step's draw from a ``torch.
Generator`` on the device, fed straight back) and ONE host fetch per
burst. The two steps are compiled (``engine/graphs.py``; JAX jits
``_tok_fn`` and ``_sample_fn``): on the card each is captured once as a
CUDA graph and a burst of K steps replays it K times, as JAX loops its
jitted step (one graph per K would multiply graphs, since K changes from
burst to burst). A gloo mesh runs them eager (``parallel/tp.py:
graph_capture``). A request that finishes mid-burst over-generates into
its own slot until the burst ends; the host drops those tokens. The first token
of each request is taken on the host from the prefill logits, sampled
with a per-request numpy generator seeded ``seed * 7919 + uid``, as in
JAX.

The cache is mutated in place: admission and recycling write the slot's
``block_tab`` row and ``seq_lens`` entry directly.

Each tick is traced (``utils/trace.py``): a ``tick`` span holding
``admit`` and ``prefill_tick`` or ``decode_burst``, each of those four
children (``prepare``: host arrays and their copies to the device;
``enqueue``: the model call or the K replays; ``fetch``: the blocking copy
to the host; ``emit``: first tokens, prefix publication, events); request
events ``submit``, ``admit``, ``first_token`` and ``finish``; and on the
card device marks before the tick's first launch, after each decode step
and after its last launch, read into the tick's attributes after its
fetch (the steps' while the next tick's work runs). A model with experts
adds the tick's ``experts_read`` (distinct experts read, summed over its
steps and layers, counted on the device and copied back behind the
tick's work, so the tick's one fetch brings it), and a model with
window layers its ``window_blocks`` (window blocks held, slots' and
registry's) and, on the ``admit`` span, ``window_tokens`` (window
tokens restored from prefix hits).

Under a ``(dp, tp)`` mesh (``parallel/mesh.py``; one process a rank)
the slots split into ``dp`` groups of ``max_batch / dp``, each with its
own ``PagePool``, prefix registry and slice of the physical pool (its
block-table values are local to that slice). Every rank runs this same
deterministic host scheduler over the whole slot table; each computes
its dp group's rows with its tp shard's heads (``parallel/tp.py``), and
a tick's results (a prefill's last logits, a burst's tokens) are
all-gathered over dp before the one host fetch, so every rank takes the
same decisions and the scheduler stays step for step the single
device's. The gather takes one shape from every group, so a prefill tick
gives each group as many rows as the group with the most prefilling
slots; a group with fewer fills its rows with its other slots, which
ride along with ``new_lens = 0``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.engine.graphs import StepGraphs
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.kv.pool import PagePool
from quest_tpu_torch.models.llama import Params, QuestModel
from quest_tpu_torch.ops.utils import resolve_device, round_up
from quest_tpu_torch.parallel.mesh import DP_AXIS, rank_device, shard_params
from quest_tpu_torch.parallel.tp import Shard, init_sharded_cache
from quest_tpu_torch.utils.trace import RECORDER, DeviceMarks


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    req: Request
    generated: List[int]
    pending: int              # next token to feed (decode phase)
    rng: np.random.Generator
    sid: int                  # PagePool sequence id
    prefill_pos: int          # prompt tokens written so far
    # Prefix cache: physical blocks borrowed from the registry (this
    # slot holds one pages_retain on them until it finishes).
    shared_blocks: List[int] = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.req.prompt)


@dataclasses.dataclass
class StepEvent:
    uid: int
    token: int
    finished: bool


class ContinuousBatchingEngine:
    """Serve many requests through a fixed-capacity slot pool.

    ``total_pages``: physical pool size in pages (one scratch block is
    added). Default ``max_batch * max_pages`` (full static reservation);
    smaller oversubscribes, and admission then waits for blocks.
    ``prefill_chunk``: at most this many prompt tokens a prefill tick
    (rounded up to ``prefill_bucket``); None = the whole prompt.
    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path.

    ``mesh``: an optional ``(dp, tp)`` DeviceMesh (``parallel/mesh.py:
    make_mesh``; the rank's device is the mesh's, and ``device`` is not
    read). ``params`` are the whole model's; the rank keeps its tp shard.
    Each dp group owns an independent slice of the physical pool with
    its own allocator, and ``total_pages`` counts usable pages PER DP
    GROUP. ``max_batch`` must be a multiple of dp.

    With window layers, the registry keeps the window state of the
    ``2 * max_batch`` prompts published last; the window blocks' pool
    holds theirs and every slot's most (the blocks covering a prefill
    chunk or a burst and the window before it).
    """

    def __init__(self, cfg: ModelConfig, quest: QuestConfig, params: Params,
                 max_batch: int = 4, prefill_bucket: int = 256,
                 seed: int = 0, burst: int = 16,
                 total_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_entries: int = 64, device="cuda", mesh=None):
        self.cfg = cfg
        self.quest = quest
        self.max_batch = max_batch
        self.prefill_bucket = prefill_bucket
        self.burst = max(1, burst)
        self.prefill_chunk = prefill_chunk
        self.mesh = mesh
        bpp = min(quest.block_pages, quest.max_pages)
        self.block_tokens = bpp * quest.page_size
        self._window = cfg.sliding_window if cfg.window_layers else 0
        if mesh is None:
            dp, self._shard = 1, None
            self.device = resolve_device(device)
            self.model = QuestModel(cfg, quest, params).to(self.device)
            if total_pages is None:
                total_pages = max_batch * quest.max_pages
            window_pages = None
            if self._window:
                self._wstate_cap = 2 * max_batch
                window_pages = bpp * (1 + self._window_pool_blocks(
                    max_batch, quest))
            self.cache = init_cache(cfg, quest, max_batch,
                                    total_pages=bpp + total_pages,
                                    device=self.device,
                                    window_pages=window_pages)
        else:
            if self._window or cfg.num_experts:
                raise NotImplementedError("window layers and experts run on "
                                          "one device")
            dp = mesh.size(mesh.mesh_dim_names.index(DP_AXIS))
            assert max_batch % dp == 0, (max_batch, dp)
            self.device = rank_device(mesh)
            self._shard = Shard(cfg, quest, mesh, shard_params(params, mesh))
            self.model = self._shard.model
            if total_pages is None:
                total_pages = (max_batch // dp) * quest.max_pages
            # The rank's shard: its dp group's rows and slice of the pool.
            self.cache = init_sharded_cache(cfg, quest, mesh, max_batch,
                                            total_pages=bpp + total_pages)
        # All table rows start at scratch; the allocators own the rest.
        self.cache.block_tab.zero_()
        self.dp = dp
        if self._window:
            # The window blocks' pool, its table's host mirror (0: scratch,
            # else 1 + the pool's block) and the registry's window state,
            # chain key -> the window blocks that end at that boundary.
            self.cache.window.block_tab.zero_()
            self.wpool = PagePool(
                self.cache.window.kv_pages.shape[2] // bpp - 1,
                self.block_tokens, max_seqs=1)
            self._wtab = np.zeros(tuple(self.cache.window.block_tab.shape),
                                  np.int32)
            self._wtab_dirty = False
            self._wstate: OrderedDict = OrderedDict()
        self._experts_host = None
        if cfg.num_experts:
            self._experts_host = torch.zeros(
                1, dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        self._slots_per_group = max_batch // dp
        # Slots [row0, row0 + slots_per_group) are this rank's cache rows.
        self._row0 = (0 if mesh is None else self._shard.dp_rank
                      * self._slots_per_group)
        n_blocks = self.cache.kv_pages.shape[2] // bpp - 1   # - scratch
        self.pools = [PagePool(n_blocks, self.block_tokens,
                               max_seqs=self._slots_per_group)
                      for _ in range(dp)]
        self._table_width = self.cache.block_tab.shape[1]
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.graphs = (StepGraphs(self.device) if mesh is None
                       else self._shard.graphs)
        self._tok_fn = self.graphs.compile(self.model.decode_token_step)
        self._sample_fn = self.graphs.compile(self.model.decode_sample_step)
        # Host mirror of per-slot lengths: burst bounds without device
        # fetches.
        self._hlens = np.zeros((max_batch,), np.int64)
        self._prefer_prefill = True
        self.last_tick: Optional[str] = None   # introspection for tests
        # Prefix registries, one a dp group: chain key -> the group's
        # physical blocks of that prefix; each entry holds one
        # pages_retain on its blocks, so shared KV outlives the donor.
        self._prefix_cap = prefix_cache_entries
        self._prefixes: List[OrderedDict] = [OrderedDict()
                                             for _ in range(dp)]
        self._chains: Dict[int, List[bytes]] = {}
        self.prefix_hits = 0            # introspection for tests
        self.prefix_hit_tokens = 0
        # Tracing (utils/trace.py): this engine's id in the recorder, its
        # device marks, and the running tick span's attributes.
        self._trace_id = RECORDER.new_engine()
        self._marks = DeviceMarks(self.device)
        self._tick_attrs: dict = {}

    # ------------------------------------------------------------------
    def _window_pool_blocks(self, max_batch: int, quest: QuestConfig) -> int:
        """Window blocks the pool needs: each slot's most at once (the
        blocks of a tick's new tokens, a prefill chunk or a burst, and of
        the window before them) and the registry's window state."""
        bt, W = self.block_tokens, self._window
        chunk = (round_up(self.prefill_chunk, self.prefill_bucket)
                 if self.prefill_chunk else quest.max_seq_len)
        nb = quest.max_pages // min(quest.block_pages, quest.max_pages)
        per_slot = min(nb, -(-(max(chunk, self.burst) + W - 1) // bt) + 1)
        return max_batch * per_slot + self._wstate_cap * self._state_blocks()

    def _state_blocks(self) -> int:
        """Window blocks that end at a block boundary and hold the window
        of the position there."""
        return -(-(self._window - 1) // self.block_tokens)

    def _map_window(self, b: int, lo: int, hi: int) -> None:
        """Slot b about to write positions [lo, hi): its window blocks
        wholly below the window of position lo go back to the pool, and
        those of [lo - W + 1, hi) are mapped (the table's device copy is
        written once a tick, :meth:`_sync_window`)."""
        bt, row = self.block_tokens, self._wtab[b]
        first = max(0, lo - self._window + 1) // bt
        gone = [int(p) - 1 for p in row[:first] if p]
        if gone:
            self.wpool.pages_release(gone)
            row[:first] = 0
            self._wtab_dirty = True
        need = [i for i in range(first, (hi - 1) // bt + 1) if not row[i]]
        if need:
            row[need] = np.asarray(self.wpool.pages_alloc(len(need))) + 1
            self._wtab_dirty = True

    def _sync_window(self) -> None:
        if self._window and self._wtab_dirty:
            self.cache.window.block_tab.copy_(torch.from_numpy(self._wtab))
            self._wtab_dirty = False

    def _drop_window_state(self, key: bytes) -> None:
        blocks = self._wstate.pop(key, None)
        if blocks:
            self.wpool.pages_release(blocks)

    def _count_experts(self, start: bool) -> None:
        """Zero the model's ``experts_read`` before a tick's first launch
        (``start``), or copy it behind its last one, to be read once the
        tick's fetch returns."""
        if self._experts_host is None:
            return
        if start:
            self.model.experts_read.zero_()
        else:
            self._experts_host.copy_(self.model.experts_read,
                                     non_blocking=True)

    def _blocks_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.block_tokens)

    def _group(self, b: int) -> int:
        """dp group owning slot ``b``."""
        return b // self._slots_per_group

    def _set_row(self, b: int, row, length: int) -> None:
        """Slot b's table row and length, in this rank's cache when its
        dp group owns the slot."""
        i = b - self._row0
        if 0 <= i < self._slots_per_group:
            self.cache.block_tab[i] = row
            self.cache.seq_lens[i] = length

    def _rows(self, x: np.ndarray) -> torch.Tensor:
        """This rank's rows of a whole-slot-table array, on its device."""
        return torch.from_numpy(
            x[self._row0:self._row0 + self._slots_per_group]).to(self.device)

    def _span(self, name: str, **attrs):
        return RECORDER.span(name, self._trace_id, **attrs)

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """Every dp group's rows of a result on the host, group by group,
        each in the order its rank passed them (the tick's one blocking
        fetch). A decode result is then in slot order; a prefill tick maps
        its rows back to slots (``row_of``)."""
        with self._span("fetch"):
            if self._shard is not None:
                t = self._shard.gather(t)
            return t.cpu().numpy()

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.quest.max_seq_len:
            raise ValueError(f"request {req.uid} exceeds max_seq_len")
        if self._blocks_needed(req) > self.pools[0].total_pages:
            raise ValueError(
                f"request {req.uid} needs {self._blocks_needed(req)} "
                f"blocks; each pool group holds {self.pools[0].total_pages}")
        self.queue.append(req)
        RECORDER.event("submit", req.uid, self._trace_id)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        return bool(self.queue) or self.num_active > 0

    # ------------------------------------------------------------------
    def _prefix_chain(self, req: Request) -> List[bytes]:
        """Chain hashes of the prompt's full blocks, capped so at least
        one prompt token is always prefilled (the slot needs real
        last-token logits). blake2b content hashing: a collision would
        alias another request's KV into the borrower. Cached per uid (a
        queued head is examined again every tick)."""
        cached = self._chains.get(req.uid)
        if cached is not None:
            return cached
        prompt = req.prompt
        m = (len(prompt) - 1) // self.block_tokens
        keys, h = [], b""
        for i in range(m):
            chunk = np.asarray(prompt[i * self.block_tokens:
                                      (i + 1) * self.block_tokens],
                               np.int64).tobytes()
            h = hashlib.blake2b(h + chunk, digest_size=16).digest()
            keys.append(h)
        self._chains[req.uid] = keys
        return keys

    def _prefix_lookup(self, g: int, keys: List[bytes]):
        """(n_shared_blocks, blocks) of group g's longest registered
        prefix (with window layers: the longest that has window state)."""
        reg = self._prefixes[g]
        for i in range(len(keys), 0, -1):
            ent = reg.get(keys[i - 1])
            if ent is not None and (not self._window
                                    or keys[i - 1] in self._wstate):
                reg.move_to_end(keys[i - 1])
                return i, ent
        return 0, []

    def _admit_slots(self) -> None:
        """Move queued requests into free slots (bookkeeping only; the
        prompt is written by later prefill ticks). FIFO: a head short on
        blocks also holds back the requests behind it (no starvation).
        A registered prompt prefix is borrowed instead of prefilled
        again: its physical blocks alias into the slot's table row and
        only the rest is reserved and written."""
        with self._span("admit") as span:
            admitted = span.attrs["admitted"] = []   # (uid, hit tokens)
            if self._window:
                span.attrs["window_tokens"] = 0
            free = [b for b, s in enumerate(self.slots) if s is None]
            while free and self.queue:
                req = self.queue[0]
                keys = self._prefix_chain(req) if self._prefix_cap else []

                def find_slot():
                    # The first free slot whose dp group's allocator has
                    # room for the unshared rest (FIFO over requests).
                    for i, b in enumerate(free):
                        g = self._group(b)
                        n_sh, blocks = self._prefix_lookup(g, keys)
                        if (self.pools[g].free_pages()
                                >= self._blocks_needed(req) - n_sh):
                            return i, (n_sh, blocks)
                    return None, None

                pick, hit = find_slot()
                # Registry holds must never starve admission (submit()
                # checked the request fits a pool): evict LRU entries, one a
                # free slot a round as JAX does, until the head fits or the
                # registries are empty.
                while pick is None:
                    evicted = False
                    for b in free:
                        reg = self._prefixes[self._group(b)]
                        if reg:
                            key, old = reg.popitem(last=False)
                            self.pools[self._group(b)].pages_release(old)
                            if self._window:
                                self._drop_window_state(key)
                            evicted = True
                    if not evicted:
                        break
                    pick, hit = find_slot()
                if pick is None:
                    break
                self.queue.popleft()
                b = free.pop(pick)
                pool = self.pools[self._group(b)]
                n_sh, shared = hit
                shared = list(shared)
                sh_tokens = n_sh * self.block_tokens
                if n_sh:
                    pool.pages_retain(shared)   # slot hold until finish
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += sh_tokens
                    if self._window:
                        # The window blocks ending at the boundary, aliased
                        # into the slot's window table (a hold each).
                        wst = self._wstate[keys[n_sh - 1]]
                        self._wstate.move_to_end(keys[n_sh - 1])
                        self.wpool.pages_retain(wst)
                        self._wtab[b, n_sh - len(wst):n_sh] = (
                            np.asarray(wst) + 1)
                        self._wtab_dirty = True
                        span.attrs["window_tokens"] += min(
                            sh_tokens, self._window - 1)
                admitted.append((req.uid, sh_tokens))
                RECORDER.event("admit", req.uid, self._trace_id)
                sid = pool.seq_create()
                # Reserve the WHOLE remaining need now: an admitted
                # request never waits for memory again.
                pool.seq_extend(sid, len(req.prompt) + req.max_new_tokens
                                - sh_tokens)
                raw, _ = pool.fill_batch_tables([sid], self._table_width,
                                                pad_page=-1)
                row = np.where(raw[0] < 0, 0, raw[0] + 1).astype(np.int32)
                row = np.concatenate([np.asarray(shared, np.int32) + 1,
                                      row])[:self._table_width]
                rng = np.random.default_rng(self._seed * 7919 + req.uid)
                self.slots[b] = _Slot(req=req, generated=[], pending=-1,
                                      rng=rng, sid=sid,
                                      prefill_pos=sh_tokens,
                                      shared_blocks=shared)
                self._hlens[b] = sh_tokens
                # Borrowed blocks carry their min/max metadata (keyed by
                # physical block): the table row IS the whole admission.
                self._set_row(b, torch.from_numpy(row).to(self.device),
                              sh_tokens)

    def _publish_prefix(self, b: int, s: _Slot) -> None:
        """Register the completed prompt's full blocks for reuse in slot
        b's group. Each entry takes its own pages_retain; LRU eviction
        releases it."""
        if not self._prefix_cap:
            return
        keys = self._prefix_chain(s.req)
        if not keys:
            return
        g = self._group(b)
        reg, pool = self._prefixes[g], self.pools[g]
        blocks = s.shared_blocks + pool.seq_pages(s.sid)
        for i, key in enumerate(keys, start=1):
            if key in reg:
                reg.move_to_end(key)
                continue
            ent = blocks[:i]
            pool.pages_retain(ent)
            reg[key] = ent
            while len(reg) > self._prefix_cap:
                old_key, old = reg.popitem(last=False)
                pool.pages_release(old)
                if self._window:
                    self._drop_window_state(old_key)
        if self._window and keys[-1] in reg:
            self._publish_window(b, len(keys), keys[-1])

    def _publish_window(self, b: int, m: int, key: bytes) -> None:
        """Keep slot b's window blocks that end at its prompt's m-th block
        boundary under ``key`` (a hold each), unless kept already or the
        slot no longer holds them; the oldest state beyond the cap goes."""
        if key in self._wstate:
            self._wstate.move_to_end(key)
            return
        row = self._wtab[b, max(0, m - self._state_blocks()):m]
        if not row.all():
            return
        blocks = [int(p) - 1 for p in row]
        self.wpool.pages_retain(blocks)
        self._wstate[key] = blocks
        while len(self._wstate) > self._wstate_cap:
            self._drop_window_state(next(iter(self._wstate)))

    # ------------------------------------------------------------------
    def _prefill_groups(self, pf: List[int]) -> List[List[int]]:
        """Each dp group's slots in a prefill call, in slot order, all of
        one length R: the group's prefilling slots of ``pf``, and where a
        group has fewer than R (the dp gather needs one shape), as many of
        its other slots, which ride along with ``new_lens = 0``: the
        shortest cached first (empty slots cost no attention), since a
        padded query row still reads its slot's whole context."""
        n = self._slots_per_group
        groups = [[b for b in pf if self._group(b) == g]
                  for g in range(self.dp)]
        R = max(map(len, groups))
        for g, rows in enumerate(groups):
            rest = sorted((b for b in range(g * n, (g + 1) * n)
                           if b not in rows), key=lambda b: self._hlens[b])
            rows += rest[:R - len(rows)]
            rows.sort()
        return groups

    def _prefill_tick(self, pf: List[int]) -> List[StepEvent]:
        """Write one prompt chunk for every prefilling slot ``pf``,
        computing only their rows (and, under dp, a group's ride-along
        rows up to the largest group's count)."""
        with self._span("prefill_tick"):
            with self._span("prepare"):
                left = {b: len(self.slots[b].req.prompt)
                        - self.slots[b].prefill_pos for b in pf}
                chunk = self.prefill_chunk or max(left.values())
                T = round_up(max(min(chunk, n) for n in left.values()),
                             self.prefill_bucket)
                n_new = {b: min(T, n) for b, n in left.items()}
                if self._window:
                    for b in pf:
                        self._map_window(b, int(self._hlens[b]),
                                         int(self._hlens[b]) + n_new[b])
                    self._sync_window()
                groups = self._prefill_groups(pf)
                rows = groups[self._group(self._row0)]     # this rank's
                R = len(rows)
                toks = np.zeros((R, T), np.int32)
                new_lens = np.zeros((R,), np.int32)
                for j, b in enumerate(rows):
                    if b in n_new:
                        s = self.slots[b]
                        toks[j, :n_new[b]] = s.req.prompt[
                            s.prefill_pos:s.prefill_pos + n_new[b]]
                        new_lens[j] = n_new[b]
                toks_dev = torch.from_numpy(toks).to(self.device)
                lens_dev = torch.from_numpy(new_lens).to(self.device)
                idx = torch.from_numpy(np.asarray(rows, np.int64)
                                       - self._row0).to(self.device)
            self._tick_attrs.update(rows=R * self.dp,
                                    prompt_tokens=sum(n_new.values()),
                                    padded_tokens=R * self.dp * T)
            with self._span("enqueue"):
                self._marks.mark()
                self._count_experts(True)
                view = self.cache.rows(idx)
                out = self.model.prefill_last(view, toks_dev, lens_dev)[:, 0]
                # In place: the captured decode steps read this tensor.
                self.cache.seq_lens.index_copy_(0, idx, view.seq_lens)
                self._count_experts(False)
                self._marks.mark()
                self._marks.settle()
            logits = self._gather(out)      # [dp * R, V], group by group
            row_of = {b: i for i, b in enumerate(
                [b for group in groups for b in group])}

            with self._span("emit"):
                events: List[StepEvent] = []
                for b in pf:
                    s = self.slots[b]
                    s.prefill_pos += n_new[b]
                    self._hlens[b] += n_new[b]
                    if not s.prefilling:  # prompt complete -> first token
                        self._publish_prefix(b, s)
                        first = self._sample(logits[row_of[b]],
                                             s.req.temperature, s.rng)
                        s.generated.append(first)
                        s.pending = first
                        RECORDER.event("first_token", s.req.uid,
                                       self._trace_id)
                        events.append(self._maybe_finish(b, s, first))
        return events

    def _decode_burst(self, decoding: List[int]) -> List[StepEvent]:
        """K chained decode steps on the device for the decoding slots,
        ONE host fetch at the end. K is bounded by the longest remaining
        request and by every decoding slot's room before max_seq_len
        (slots that finish mid-burst keep appending until it ends)."""
        with self._span("decode_burst"):
            with self._span("prepare"):
                B = self.max_batch
                toks = np.zeros((B,), np.int32)
                active = np.zeros((B,), bool)
                temps = np.zeros((B,), np.float32)
                for b in decoding:
                    s = self.slots[b]
                    toks[b] = s.pending
                    active[b] = True
                    temps[b] = max(s.req.temperature, 0.0)
                remaining = max(self.slots[b].req.max_new_tokens
                                - len(self.slots[b].generated)
                                for b in decoding)
                headroom = min(self.quest.max_seq_len - int(self._hlens[b])
                               for b in decoding)
                K = max(1, min(self.burst, remaining, headroom))
                if self._window:
                    for b in decoding:
                        self._map_window(b, int(self._hlens[b]),
                                         int(self._hlens[b]) + K)
                    self._sync_window()
                act = self._rows(active)
                tok = self._rows(toks)
                temps_dev = self._rows(temps) if temps.any() else None
            self._tick_attrs.update(rows=len(decoding), steps=K)
            with self._span("enqueue"):
                self._marks.mark()
                self._count_experts(True)
                outs = []
                for _ in range(K):
                    if temps_dev is None:
                        tok = self._tok_fn(self.cache, tok, act)
                    else:
                        tok = self._sample_fn(self.cache, tok, self._gen,
                                              temps_dev, act)
                    tok = tok.clone()       # the step's output is static
                    outs.append(tok)
                    self._marks.mark()
                out = torch.stack(outs, dim=1)                   # [B, K]
                self._count_experts(False)
                self._marks.mark()
                self._marks.settle()
            arr = self._gather(out)

            with self._span("emit"):
                for b in decoding:
                    self._hlens[b] += K
                # Emit in token-time order (step-major) so cross-request
                # finish order matches the unbatched semantics.
                events: List[StepEvent] = []
                done = set()
                for k in range(K):
                    for b in decoding:
                        if b in done:
                            continue    # the burst's junk tail is dropped
                        slot = self.slots[b]
                        nxt = int(arr[b, k])
                        slot.generated.append(nxt)
                        slot.pending = nxt
                        ev = self._maybe_finish(b, slot, nxt)
                        events.append(ev)
                        if ev.finished:
                            done.add(b)
        return events

    def step(self) -> List[StepEvent]:
        """One scheduler tick; returns per-request token events. The tick
        is one ``tick`` span of the recorder (utils/trace.py) whose
        attributes are the tick's kind, the rows it computed (every dp
        group's), its steps or its prompt tokens and the tokens it
        computed (``padded_tokens``: rows x the padded width), the
        prefix-hit tokens gained, the queue, each pool group's free
        blocks, whether work is left, and on the card its device times."""
        with self._span("tick") as span:
            self._tick_attrs = span.attrs
            hits = self.prefix_hit_tokens
            events = self._run_tick()
            work_left = self.has_work()
            span.attrs.update(
                kind=self.last_tick, hit_tokens=self.prefix_hit_tokens - hits,
                queue=len(self.queue),
                free_blocks=[p.free_pages() for p in self.pools],
                work_left=work_left)
            if self._experts_host is not None and self.last_tick:
                span.attrs["experts_read"] = int(self._experts_host[0])
            if self._window:
                span.attrs["window_blocks"] = (self.wpool.total_pages
                                               - self.wpool.free_pages())
            self._marks.read(span.attrs)
            if not work_left:
                self._marks.settle()
            self._tick_attrs = {}
        return events

    def _run_tick(self) -> List[StepEvent]:
        self._admit_slots()
        prefilling = [b for b, s in enumerate(self.slots)
                      if s is not None and s.prefilling]
        decoding = [b for b, s in enumerate(self.slots)
                    if s is not None and not s.prefilling]
        # Alternate prefill chunks and decode bursts so neither phase
        # starves the other.
        if prefilling and (self._prefer_prefill or not decoding):
            self._prefer_prefill = False
            self.last_tick = "prefill"
            return self._prefill_tick(prefilling)
        self._prefer_prefill = True
        if not decoding:
            self.last_tick = None
            return []
        self.last_tick = "decode"
        return self._decode_burst(decoding)

    def _maybe_finish(self, b: int, slot: _Slot, token: int) -> StepEvent:
        req = slot.req
        done = (len(slot.generated) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and token == req.eos_token_id))
        if done:
            RECORDER.event("finish", req.uid, self._trace_id)
            self.slots[b] = None
            # Recycle: blocks back to the slot's group allocator, table
            # row to scratch, length to 0. Borrowed prefix blocks drop
            # this slot's hold (the registry keeps its own).
            pool = self.pools[self._group(b)]
            if slot.shared_blocks:
                pool.pages_release(slot.shared_blocks)
            pool.seq_release(slot.sid)
            if self._window:
                held = [int(p) - 1 for p in self._wtab[b] if p]
                if held:
                    self.wpool.pages_release(held)
                self._wtab[b] = 0
                self._wtab_dirty = True
            self._chains.pop(req.uid, None)
            self._hlens[b] = 0
            self._set_row(b, 0, 0)
        return StepEvent(uid=req.uid, token=token, finished=done)

    @staticmethod
    def _sample(logits: np.ndarray, temperature: float,
                rng: np.random.Generator) -> int:
        if temperature <= 0.0:
            return int(np.argmax(logits))
        x = logits.astype(np.float64) / temperature
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Submit everything, tick until drained, return generations."""
        for r in requests:
            self.submit(r)
        out: Dict[int, List[int]] = {}
        gens: Dict[int, List[int]] = {r.uid: [] for r in requests}
        while self.has_work():
            for ev in self.step():
                gens[ev.uid].append(ev.token)
                if ev.finished:
                    out[ev.uid] = gens[ev.uid]
        return out

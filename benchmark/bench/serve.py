"""Serve a cell's traffic through ``ContinuousBatchingEngine`` and record
what happens: each scheduler tick (its kind, host times, rows and
lengths), each request (due, submitted, first and last token, the tokens
served) and the harness's spans around the engine's calls.

The spans are recorded from here, around the engine's own methods of
the one instance the run builds (``_admit_slots`` -> ``admit``,
``_prefill_tick`` -> ``prefill_tick``, ``_decode_burst`` ->
``decode_burst``, ``_gather``, the tick's one host fetch ->
``host_fetch``), and around each ``step()`` -> ``tick``; while a profiler
runs each span is also a ``record_function`` named ``bench.<span>``,
so the trace places it beside the kernels. Nothing of the program is
edited.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from bench.mix import Req, Traffic

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class ReqState:
    uid: int
    req: Req
    due: float                 # host clock: when it was due
    client: Optional[int] = None
    submitted: float = 0.0
    first: Optional[float] = None
    last: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    in_window: bool = False    # due inside the window

    @property
    def prompt_tokens(self) -> int:
        return int(self.req.tail.size) + (0 if self.req.doc is None
                                          else self.doc_tokens)

    doc_tokens: int = 0


@dataclasses.dataclass
class Tick:
    kind: Optional[str]
    t0: float
    t1: float
    events: int = 0
    steps: int = 0                 # decode steps (compiled calls)
    decode_rows: List[tuple] = dataclasses.field(default_factory=list)
    prefill_rows: List[tuple] = dataclasses.field(default_factory=list)
    width: int = 0                 # prefill tick's padded tokens a row
    admitted: List[int] = dataclasses.field(default_factory=list)
    hit_tokens: int = 0
    profiled: bool = False


@dataclasses.dataclass
class Record:
    """What a run saw; the metric readers take it (``benchmark/metrics``)."""

    cell: Dict
    dims: Dict
    quest: Dict
    engine: Dict
    seconds: float
    setup_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    ticks: List[Tick] = dataclasses.field(default_factory=list)
    requests: Dict[int, ReqState] = dataclasses.field(default_factory=dict)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    device: Optional[Dict] = None      # the profiled sub-window (trace.py)
    peaks: Optional[Dict] = None
    lateness: List[float] = dataclasses.field(default_factory=list)
    here: Optional[object] = None      # the benchmark's folder
    t_stop: float = 0.0                # the drain's end

    def window_ticks(self, profiled: Optional[bool] = None) -> List[Tick]:
        """Ticks that ended inside the window, the one running at its end
        included (optionally only those in or out of the profiled
        sub-window)."""
        return [t for t in self.ticks if self.t_open <= t.t1 <= self.t_close
                and (profiled is None or t.profiled == profiled)]

    def window_requests(self) -> List[ReqState]:
        return [r for r in self.requests.values() if r.in_window]


def _span(rec_spans: List[tuple], name: str):
    """A host span (perf_counter times), and a ``record_function`` while
    a profiler runs."""
    @contextlib.contextmanager
    def cm():
        prof = (torch.profiler.record_function(SPAN_PREFIX + name)
                if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            yield
        rec_spans.append((name, t0, time.perf_counter()))
    return cm()


class Instrument:
    """Wraps the engine instance's methods to record spans and each tick's
    rows (see the module's docstring)."""

    def __init__(self, eng, rec: Record, uid_doc: Dict[int, Optional[int]]):
        self.eng, self.rec, self.uid_doc = eng, rec, uid_doc
        self.tick: Optional[Tick] = None
        orig = {n: getattr(eng, n) for n in
                ("_admit_slots", "_prefill_tick", "_decode_burst", "_gather")}
        self._orig = orig
        self._prefill_last = eng.model.prefill_last

        def admit():
            before = set(b for b, s in enumerate(eng.slots) if s is not None)
            hits = eng.prefix_hit_tokens
            with _span(rec.spans, "admit"):
                orig["_admit_slots"]()
            if self.tick is not None:
                self.tick.admitted += [eng.slots[b].req.uid
                                       for b, s in enumerate(eng.slots)
                                       if s is not None and b not in before]
                self.tick.hit_tokens += eng.prefix_hit_tokens - hits

        def prefill_tick(pf):
            slots = [(b, eng.slots[b], eng.slots[b].prefill_pos) for b in pf]
            with _span(rec.spans, "prefill_tick"):
                out = orig["_prefill_tick"](pf)
            if self.tick is not None:
                self.tick.prefill_rows = [
                    (pos, s.prefill_pos - pos, uid_doc.get(s.req.uid),
                     s.req.uid) for b, s, pos in slots]
            return out

        def decode_burst(decoding):
            rows = [(int(eng._hlens[b]), uid_doc.get(eng.slots[b].req.uid),
                     eng.slots[b].req.uid,
                     eng.slots[b].req.max_new_tokens
                     - len(eng.slots[b].generated)) for b in decoding]
            calls = eng._tok_fn.calls + eng._sample_fn.calls
            with _span(rec.spans, "decode_burst"):
                out = orig["_decode_burst"](decoding)
            if self.tick is not None:
                self.tick.decode_rows = rows
                self.tick.steps = (eng._tok_fn.calls + eng._sample_fn.calls
                                   - calls)
            return out

        def gather(t):
            with _span(rec.spans, "host_fetch"):
                return orig["_gather"](t)

        def prefill_last(cache, toks, new_lens=None):
            if self.tick is not None:
                self.tick.width = int(toks.shape[1])
            return self._prefill_last(cache, toks, new_lens)

        eng._admit_slots = admit
        eng._prefill_tick = prefill_tick
        eng._decode_burst = decode_burst
        eng._gather = gather
        eng.model.prefill_last = prefill_last

    def step(self) -> tuple:
        """One ``eng.step()`` as a recorded tick: (tick, events)."""
        t0 = time.perf_counter()
        self.tick = Tick(kind=None, t0=t0, t1=t0)
        with _span(self.rec.spans, "tick"):
            events = self.eng.step()
        tick, self.tick = self.tick, None
        tick.t1 = time.perf_counter()
        tick.kind = self.eng.last_tick
        tick.events = len(events)
        return tick, events

    def detach(self) -> None:
        """Drop the wrappers (and with them the references to the engine)."""
        for n in self._orig:
            self.eng.__dict__.pop(n, None)
        self.eng.model.__dict__.pop("prefill_last", None)
        self._orig = {}
        self._prefill_last = None


class Server:
    """The engine, the request table and the window's loop."""

    def __init__(self, eng, traffic: Traffic, rec: Record):
        self.eng, self.traffic, self.rec = eng, traffic, rec
        self.uid_doc: Dict[int, Optional[int]] = {}
        self.inst = Instrument(eng, rec, self.uid_doc)
        self._next_uid = 0
        self._doc_lists = [d.tolist() for d in traffic.docs]

    def submit(self, req: Req, due: float, client=None,
               in_window=False) -> ReqState:
        from quest_tpu_torch.engine.scheduler import Request
        uid = self._next_uid
        self._next_uid += 1
        prompt = ((self._doc_lists[req.doc] if req.doc is not None else [])
                  + req.tail.tolist())
        st = ReqState(uid=uid, req=req, due=due, client=client,
                      in_window=in_window,
                      doc_tokens=(0 if req.doc is None
                                  else len(self._doc_lists[req.doc])))
        self.uid_doc[uid] = req.doc
        self.rec.requests[uid] = st
        st.submitted = time.perf_counter()
        self.eng.submit(Request(uid, prompt, req.max_new))
        return st

    def _apply(self, events, t: float) -> List[ReqState]:
        finished = []
        for ev in events:
            st = self.rec.requests[ev.uid]
            st.tokens.append(int(ev.token))
            if st.first is None:
                st.first = t
            st.last = t
            if ev.finished:
                st.done = True
                finished.append(st)
        return finished

    def serve_all(self, reqs: List[Req]) -> None:
        """Serve ``reqs`` to completion (set-up: not recorded as ticks)."""
        now = time.perf_counter()
        for r in reqs:
            self.submit(r, now)
        while self.eng.has_work():
            _, events = self.inst.step()
            self._apply(events, time.perf_counter())

    def window(self, seconds: float, tracer=None) -> None:
        """Open the window, run the traffic's loop for ``seconds``, then
        drain what is in flight (at most ``traffic.drain_s``)."""
        rec, tr = self.rec, self.traffic
        gc.collect()
        gc.freeze()
        rec.ticks, rec.spans = [], []
        t_open = time.perf_counter()
        t_end = t_open + seconds
        rec.t_open = t_open
        closed = tr.clients is not None
        nxt = []
        pending = []
        if closed:
            for c, reqs in enumerate(tr.clients):
                self.submit(reqs[0], t_open, client=c, in_window=True)
            nxt = [1] * len(tr.clients)
        else:
            pending = [(t_open + due, r) for due, r in tr.arrivals
                       if due < seconds]
        pi = 0
        # The window closes at its end, or at the end of the tick running
        # then: that tick's events and time are the window's.
        t_close = t_end
        drain_until = None
        while True:
            now = time.perf_counter()
            while pi < len(pending) and pending[pi][0] <= now:
                due, r = pending[pi]
                st = self.submit(r, due, in_window=True)
                rec.lateness.append(st.submitted - due)
                pi += 1
            if drain_until is None and now >= t_end:
                drain_until = now + tr.drain_s
            if drain_until is not None and now >= drain_until:
                break
            if not self.eng.has_work():
                if pi < len(pending):
                    wait = pending[pi][0] - time.perf_counter()
                elif not closed and now < t_end:
                    wait = t_end - now
                else:
                    break
                if wait > 0.002:
                    time.sleep(wait - 0.001)
                continue
            if tracer is not None:
                tracer.before_tick(now - t_open, seconds)
            tick, events = self.inst.step()
            if tracer is not None:
                tick.profiled = tracer.after_tick()
            rec.ticks.append(tick)
            for st in self._apply(events, tick.t1):
                if closed and tick.t1 < t_end and st.client is not None:
                    c = st.client
                    if nxt[c] < len(tr.clients[c]):
                        self.submit(tr.clients[c][nxt[c]], tick.t1, client=c,
                                    in_window=True)
                        nxt[c] += 1
            if tick.t0 < t_end < tick.t1:
                t_close = tick.t1
        if tracer is not None:
            tracer.finish()
        rec.t_close = t_close
        rec.t_stop = time.perf_counter()
        gc.unfreeze()


def build_engine(cfg, quest_cfg: Dict, weights: Dict, eng: Dict,
                 seed: int, device):
    """The cell's ``ContinuousBatchingEngine`` over ``weights``; ``cfg`` is
    the port's model configuration (the family's ``model_config``)."""
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine

    q = dict(quest_cfg)
    q["kv_dtype"] = getattr(torch, q["kv_dtype"])
    q["meta_dtype"] = getattr(torch, q["meta_dtype"])
    quest = QuestConfig(**q)
    bpp = min(quest.block_pages, quest.max_pages)
    return ContinuousBatchingEngine(
        cfg, quest, weights, max_batch=eng["max_batch"],
        prefill_bucket=eng["prefill_bucket"], seed=int(seed),
        burst=eng["burst"], total_pages=eng["pool_blocks"] * bpp,
        prefill_chunk=eng["prefill_chunk"],
        prefix_cache_entries=eng["prefix_cache_entries"], device=device)

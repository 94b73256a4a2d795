"""Continuous-batching scheduler over the slot-paged KV cache (counterpart
of ``repro/serve/engine.py``).

One :class:`Engine` owns ``num_slots`` request slots, one page arena per
attention layer (:mod:`repro_torch.serve.kv`) for its whole life, and two
steps:

* ``chunk_prefill``: pages in ONE waiting request's next ``prefill_chunk``
  prompt tokens (fixed ``(1, C)`` shape; a short final chunk is padded,
  and its padded positions lie past the slot's length, never valid before
  decode overwrites them);
* ``decode``: one greedy token for EVERY slot (fixed ``(num_slots, 1)``
  shape; slots not decoding carry the trash page and length 0, so their
  writes land in page 0 and their logits are not read).

Every tick admits arrived requests into free slots (a free-list pop), runs
one prefill chunk if a slot is mid-prompt, then one decode step if a slot
is generating: requests join and leave the batch between decode steps.
``static=True`` is the baseline: admit only when every slot is free,
decode only once every admitted prompt is paged in.

The steps write the arena in place, and argmax is taken on the card: only
the ``(C,)`` or ``(num_slots,)`` token ids come back to the host.  Each
tick's page table, lengths and tokens go to the card in one copy from
pinned memory that does not block the host; a decode tick blocks once, on
its tokens, and a prefill chunk once, on its first token, where the prompt
ends.

Greedy decoding only.  A request retires at its ``max_gen`` bound, on
``EngineConfig.eos_id``, or when its generation ends with one of
``EngineConfig.stop_seqs``; retiring frees its pages at once.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import lm
from repro_torch.serve import kv as kv_lib

FREE, PREFILL, DECODE = 0, 1, 2


@dataclass
class Request:
    """One serving request.  ``arrival`` is seconds after ``run()`` starts
    (0 = backlogged); the engine fills the telemetry fields."""
    rid: int
    prompt: Sequence[int]
    max_gen: int
    arrival: float = 0.0
    generated: List[int] = field(default_factory=list)
    t_admit: float = -1.0
    t_first: float = -1.0   # first generated token (end of prefill)
    t_done: float = -1.0


@dataclass
class EngineConfig:
    num_slots: int = 4
    page_size: int = 16
    max_ctx: int = 256          # per-request prompt + generation bound
    prefill_chunk: int = 32
    kv_quant: Optional[str] = None      # None | "int8"
    num_pages: Optional[int] = None     # default: every slot can fill up
    eos_id: Optional[int] = None        # retire the slot on this token
    stop_seqs: Sequence[Sequence[int]] = ()   # ...or on any of these tails

    @property
    def max_pages(self) -> int:
        return -(-self.max_ctx // self.page_size)

    def resolved_num_pages(self) -> int:
        return self.num_pages if self.num_pages is not None \
            else 1 + self.num_slots * self.max_pages


class Engine:
    """``params``: the nested parameter dict (or an ``lm.LM``); the arena
    is allocated on its device."""

    def __init__(self, cfg, params, ecfg: Optional[EngineConfig] = None):
        ecfg = ecfg or EngineConfig()
        if cfg.arch_class == "encdec":
            raise NotImplementedError(
                "Engine serves decoder-only archs; encoder-decoder decoding "
                "is repro_torch.models.encdec.decode_stack (see "
                "tests/test_torch_encdec.py)")
        bad = [k for k in cfg.pattern if k.split("+")[0] != "attn"]
        if bad or cfg.window:
            raise NotImplementedError(
                f"paged serving covers full-attention decoder stacks; "
                f"pattern {cfg.pattern} window {cfg.window} has no "
                f"page-table layout (sliding windows ring-buffer, "
                f"recurrent mixers keep O(1) state)")
        if getattr(cfg, "mrope_sections", None):
            raise NotImplementedError("paged serving does not thread "
                                      "multimodal rope position trees")
        np_ = ecfg.resolved_num_pages()
        if np_ < 1 + ecfg.max_pages:
            raise ValueError(
                f"num_pages={np_} cannot hold even one full request "
                f"({ecfg.max_pages} pages) plus the trash page")
        if isinstance(params, lm.LM):
            params = params.tree()
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.device = params["embed"]["embedding"].device
        self.num_pages = np_
        self.pools = lm.init_paged_caches(cfg, np_, ecfg.page_size,
                                          kv_quant=ecfg.kv_quant,
                                          device=self.device)
        self._chunk = lm.make_chunk_prefill_step(cfg)
        self._decode = lm.make_paged_decode_step(cfg)
        self._tel = obs.get()   # re-resolved per run(); see there
        self.reset()

    # -- bookkeeping -------------------------------------------------------
    def reset(self):
        """Clear scheduler state between runs.  The pools are NOT zeroed:
        stale entries sit past every slot's length, so correctness never
        depends on arena contents."""
        e = self.ecfg
        self.page_table = np.zeros((e.num_slots, e.max_pages), np.int32)
        self.lens = np.zeros((e.num_slots,), np.int32)
        self.free_pages = list(range(self.num_pages - 1, 0, -1))  # pop -> 1,2,..
        self.slots = [{"state": FREE, "req": None, "filled": 0,
                       "pages": [], "last": 0} for _ in range(e.num_slots)]

    def kv_bytes(self) -> int:
        return kv_lib.pool_bytes(self.pools)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str,
                        ecfg: Optional[EngineConfig] = None,
                        step: Optional[int] = None, device="cuda",
                        merge_lora: Optional[bool] = None,
                        lora_rank: int = 8, lora_alpha: float = 16.0
                        ) -> "Engine":
        """An engine straight from a training checkpoint directory, loading
        only the params leaves to ``device``
        (``CheckpointManager.restore_params``).

        A LoRA fine-tune's checkpoint holds a ``{"base", "lora"}`` tree;
        the engine's forward knows nothing of adapters, so they are merged
        into the base weights at load (``models.lora.merge``).
        ``merge_lora=None`` detects the fine-tune from the run metadata
        (``--finetune lora`` records its rank and alpha there); pass
        ``True`` with ``lora_rank``/``lora_alpha`` for a checkpoint written
        without it."""
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(ckpt_dir)
        ft = mgr.saved_run(step).get("finetune") or {}
        if merge_lora is None:
            merge_lora = ft.get("mode") == "lora"
        like = lm.abstract_params(cfg)
        if merge_lora:
            from repro_torch.models import lora
            rank = int(ft.get("rank", lora_rank))
            alpha = float(ft.get("alpha", lora_alpha))
            tree, _ = mgr.restore_params(
                step, lora.inject(like, rank, (0, 0)), device=device)
            params = lora.merge(tree, alpha, rank)
        else:
            params, _ = mgr.restore_params(step, like, device=device)
        return cls(cfg, params, ecfg)

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """The tick's int32 host arrays as views of ONE device buffer, in
        the order given.  On the card the copy leaves pinned memory
        without blocking the host; the pinned block is not reused before
        the copy has run (the caching host allocator waits on it)."""
        host = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32).ravel() for a in arrays]))
        if self.device.type == "cuda":
            host = host.pin_memory().to(self.device, non_blocking=True)
        out, i = [], 0
        for a in arrays:
            out.append(host[i:i + a.size].view(a.shape))
            i += a.size
        return out

    def _chunk_step(self, pt: np.ndarray, filled: int, tokens: np.ndarray
                    ) -> torch.Tensor:
        """Greedy ids ``(C,)`` of one prompt chunk, on the device."""
        pt_d, filled_d, tokens_d = self._upload(
            pt, np.array([filled]), tokens)
        logits, _ = self._chunk(self.params, self.pools, pt_d, filled_d,
                                tokens_d)
        return torch.argmax(logits[0], dim=-1)

    def _decode_step(self, pt: np.ndarray, lens: np.ndarray,
                     tokens: np.ndarray) -> torch.Tensor:
        """Greedy ids ``(num_slots,)`` of one decode tick, on the device."""
        logits, _ = self._decode(self.params, self.pools,
                                 *self._upload(pt, lens, tokens))
        return torch.argmax(logits, dim=-1)

    def warmup(self):
        """Run both steps once against the trash page, so timed runs find
        the allocator's and libraries' first-call work done."""
        e = self.ecfg
        self._chunk_step(np.zeros((1, e.max_pages), np.int32), 0,
                         np.zeros((1, e.prefill_chunk), np.int32))
        self._decode_step(np.zeros((e.num_slots, e.max_pages), np.int32),
                          np.zeros((e.num_slots,), np.int32),
                          np.zeros((e.num_slots, 1), np.int32)).tolist()

    # -- scheduling --------------------------------------------------------
    def _admit_one(self, req: Request, slot: int, now: float) -> bool:
        plen, cap = len(req.prompt), self.ecfg.max_ctx
        if plen + req.max_gen > cap:
            raise ValueError(f"request {req.rid}: prompt {plen} + gen "
                             f"{req.max_gen} exceeds max_ctx {cap}")
        need = -(-(plen + req.max_gen) // self.ecfg.page_size)
        if len(self.free_pages) < need:
            return False
        pages = [self.free_pages.pop() for _ in range(need)]
        self.page_table[slot, :] = kv_lib.TRASH_PAGE
        self.page_table[slot, :need] = pages
        self.lens[slot] = 0
        s = self.slots[slot]
        s.update(state=PREFILL, req=req, filled=0, pages=pages, last=0)
        req.t_admit = now
        return True

    def _admit(self, pending: deque, now: float, static: bool):
        if static and any(s["state"] != FREE for s in self.slots):
            return  # static waves: the whole batch drains before refill
        for slot, s in enumerate(self.slots):
            if not pending or pending[0].arrival > now:
                break
            if s["state"] != FREE:
                continue
            if not self._admit_one(pending[0], slot, now):
                break   # page pressure: keep FIFO order, wait for retires
            pending.popleft()

    def _finished(self, req: Request) -> bool:
        """max_gen bound, EOS token, or a stop-sequence tail, checked after
        every appended token (prefill's first token included), so a
        stopped slot frees its pages before the next admit pass."""
        if len(req.generated) >= req.max_gen:
            return True
        e = self.ecfg
        if e.eos_id is not None and req.generated \
                and req.generated[-1] == e.eos_id:
            return True
        return any(stop and len(req.generated) >= len(stop)
                   and req.generated[-len(stop):] == list(stop)
                   for stop in e.stop_seqs)

    def _retire(self, slot: int, now: float):
        s = self.slots[slot]
        self.free_pages.extend(sorted(s["pages"], reverse=True))
        self.page_table[slot, :] = kv_lib.TRASH_PAGE
        self.lens[slot] = 0
        req = s["req"]
        req.t_done = now
        # the per-request record goes out at retirement: a killed run
        # keeps one line per completed request
        self._tel.emit(
            "serve_request", rid=req.rid, slot=slot,
            prompt_tokens=len(req.prompt), gen_tokens=len(req.generated),
            arrival_s=req.arrival, admit_s=req.t_admit,
            first_token_s=req.t_first, done_s=req.t_done,
            ttft_s=req.t_first - req.t_admit,
            latency_s=req.t_done - req.arrival)
        s.update(state=FREE, req=None, filled=0, pages=[], last=0)

    def _prefill_tick(self, now) -> bool:
        slot = next((i for i, s in enumerate(self.slots)
                     if s["state"] == PREFILL), None)
        if slot is None:
            return False
        s = self.slots[slot]
        req, C = s["req"], self.ecfg.prefill_chunk
        plen = len(req.prompt)
        chunk = list(req.prompt[s["filled"]:s["filled"] + C])
        real = len(chunk)
        tokens = np.array([chunk + [0] * (C - real)], np.int32)
        with self._tel.span("prefill", cat="serve", slot=slot,
                            rid=req.rid, tokens=real):
            greedy = self._chunk_step(self.page_table[slot:slot + 1],
                                      s["filled"], tokens)
        s["filled"] += real
        if s["filled"] >= plen:
            # prompt fully paged in: its last position's greedy token is
            # in THIS chunk (mid-chunk when the tail was padded)
            g0 = int(greedy[plen - 1 - (s["filled"] - real)].item())
            req.generated.append(g0)
            req.t_first = now()
            self.lens[slot] = plen
            if self._finished(req):
                self._retire(slot, now())
            else:
                s.update(state=DECODE, last=g0)
        return True

    def _decode_tick(self, now, static: bool) -> bool:
        active = [i for i, s in enumerate(self.slots)
                  if s["state"] == DECODE]
        if not active:
            return False
        if static and any(s["state"] == PREFILL for s in self.slots):
            return False  # static baseline: decode starts when the wave is in
        e = self.ecfg
        tokens = np.zeros((e.num_slots, 1), np.int32)
        pt = np.zeros_like(self.page_table)     # non-decode rows -> trash
        ln = np.zeros_like(self.lens)
        for i in active:
            tokens[i, 0] = self.slots[i]["last"]
            pt[i] = self.page_table[i]
            ln[i] = self.lens[i]
        with self._tel.span("decode", cat="serve", active=len(active)):
            nxt = self._decode_step(pt, ln, tokens).tolist()
        for i in active:
            s = self.slots[i]
            self.lens[i] += 1
            tok = nxt[i]
            s["req"].generated.append(tok)
            s["last"] = tok
            if self._finished(s["req"]):
                self._retire(i, now())
        return True

    def run(self, requests: Sequence[Request], static: bool = False) -> dict:
        """Serve ``requests`` to completion under open-loop arrivals (each
        joins the queue at its ``arrival`` offset, whether or not the
        engine keeps up).  Returns aggregate stats; the per-request
        telemetry lands on the Request objects."""
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        # late-bound: the launcher configures the global Telemetry after
        # engine construction; ticks and _retire read self._tel
        tel = self._tel = obs.get()
        t0 = time.monotonic()
        now = lambda: time.monotonic() - t0
        arena = max(self.num_pages - 1, 1)   # page 0 is the trash page
        while pending or any(s["state"] != FREE for s in self.slots):
            self._admit(pending, now(), static)
            busy = self._prefill_tick(now)
            busy = self._decode_tick(now, static) or busy
            if busy and tel.tracer is not None:
                tel.counter(
                    "sched", cat="serve",
                    queue_depth=sum(r.arrival <= now() for r in pending),
                    slots_busy=sum(s["state"] != FREE for s in self.slots),
                    page_util=1.0 - len(self.free_pages) / arena)
            if not busy and pending:
                time.sleep(max(0.0, min(pending[0].arrival - now(), 0.02)))
        makespan = now()
        lat = sorted(r.t_done - r.arrival for r in requests)
        gen = sum(len(r.generated) for r in requests)
        pct = lambda p: lat[min(len(lat) - 1,
                                int(p / 100.0 * len(lat)))] if lat else 0.0
        stats = {"requests": len(requests),
                 "generated_tokens": gen,
                 "prompt_tokens": sum(len(r.prompt) for r in requests),
                 "makespan_s": makespan,
                 "requests_per_sec": len(requests) / makespan,
                 "tokens_per_sec": gen / makespan,
                 "p50_s": pct(50), "p99_s": pct(99)}
        tel.emit("serve_run", static=static, **stats)
        return stats

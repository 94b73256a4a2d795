"""Slot-paged KV-cache pools (counterpart of ``repro/serve/kv.py``).

A serving KV cache is ONE arena per attention layer: a pool of
``num_pages`` blocks of ``page_size`` token entries, shared by every
request in flight.  Slot ``b`` owns the pages its page-table row names;
its logical position ``t`` lives at ``(page_table[b, t // page_size],
t % page_size)``.  Admitting a request pops pages off a free list and
retiring it pushes them back; nothing is resized or compacted.

Two pool encodings:

* ``None``: a ``(num_pages, page_size, KV, hd)`` tensor in the model
  dtype;
* ``"int8"``: ``{"q": int8 (num_pages, page_size, KV, hd), "scale": f32
  (num_pages, page_size, KV)}``, each written head vector quantized
  against its own absmax by ``optim.codec.blocked_quant`` with ``block =
  head_dim`` and round-to-nearest (an entry is encoded once, so the
  optimizer's stochastic rounding would only add noise).

Page 0 is the TRASH page: free slots' rows point at it, so the fixed-shape
decode step writes a token for every slot each tick and the inactive ones
land in trash, never read (their length masks it out).

The pools are written IN PLACE (``index_put_``) under inference mode:
one arena for the engine's whole life, where the JAX package returns new
pools and relies on buffer donation to alias them.  Reads gather a slot's
pages into a transient contiguous ``(B, max_pages·page_size, KV, hd)``
view, as the reference does.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.optim import codec

TRASH_PAGE = 0


def is_quantized(pool) -> bool:
    return isinstance(pool, Mapping)


def page_size(pool) -> int:
    return (pool["q"] if is_quantized(pool) else pool).shape[1]


def capacity(pool, page_table: torch.Tensor) -> int:
    """Tokens addressable through one page-table row: max_pages · page."""
    return int(page_table.shape[-1]) * page_size(pool)


def quant_entries(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., KV, hd) -> (q int8 same shape, scale f32 (..., KV))``: one
    absmax block per head vector (``block = head_dim``, round-to-nearest)."""
    q, scale = codec.blocked_quant(x, 0, block=int(x.shape[-1]),
                                   rounding="nearest")
    return q, scale.reshape(x.shape[:-1])


def write(pool, page: torch.Tensor, off: torch.Tensor,
          val: torch.Tensor) -> None:
    """Scatter token entries into ``pool`` in place.

    ``val`` is ``(N, KV, hd)``; ``page``/``off`` are ``(N,)`` destinations.
    Live destinations are distinct (each slot owns its pages); duplicates
    occur only on the trash page, where ``index_put_`` on CUDA picks an
    unspecified winner, which is fine: trash is never read.
    """
    if is_quantized(pool):
        q, scale = quant_entries(val)
        pool["q"].index_put_((page, off), q)
        pool["scale"].index_put_((page, off), scale)
    else:
        pool.index_put_((page, off), val.to(pool.dtype))


def gather(pool, page_table: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """Page-table rows as a contiguous transient view: ``(B, max_pages) ->
    (B, max_pages·page_size, KV, hd)`` in ``dtype`` (int8 pools dequantize
    on the way out)."""
    if is_quantized(pool):
        q = pool["q"][page_table]                 # (B, MP, P, KV, hd)
        s = pool["scale"][page_table]             # (B, MP, P, KV)
        x = (q.float() * s[..., None]).to(dtype)
    else:
        x = pool[page_table].to(dtype)
    B, MP, P = x.shape[:3]
    return x.reshape(B, MP * P, *x.shape[3:])


def token_dest(page_table: torch.Tensor, pos: torch.Tensor, page: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot decode destination: slot ``b``'s next entry goes to
    ``(page_table[b, pos[b] // page], pos[b] % page)``."""
    B = page_table.shape[0]
    rows = torch.arange(B, device=page_table.device)
    return page_table[rows, pos // page], pos % page


def chunk_dest(pt_row: torch.Tensor, start: torch.Tensor, n: int, page: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill-chunk destinations: positions ``start .. start+n-1`` of the
    one slot whose page-table row is ``pt_row`` ``(max_pages,)``.

    A padded final chunk can reach past the row's ``max_pages · page``
    positions when the chunk is longer than the generation budget.  Those
    padded entries go to the trash page.  (The JAX package's gather clamps
    them onto the row's last page instead, where they can overwrite real
    prompt entries written by the same scatter; an index past the row
    would abort a CUDA launch.)"""
    positions = start + torch.arange(n, device=pt_row.device)
    idx = positions // page
    inside = idx < pt_row.shape[0]
    pg = torch.where(inside, pt_row[idx.clamp(max=pt_row.shape[0] - 1)],
                     TRASH_PAGE)
    return pg, positions % page


def pool_bytes(pools) -> int:
    """Persistent arena bytes of a paged-cache tree (what int8 pages
    shrink)."""
    if isinstance(pools, torch.Tensor):
        return pools.numel() * pools.element_size()
    return sum(pool_bytes(v) for v in pools.values())

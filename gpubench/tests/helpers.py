"""Shared pieces of the benchmark's CPU tests: the repository on the
import path, torch held to two threads, and a cell cut to a size the CPU
runs in seconds (2 layers of width 64; the cell's own files otherwise)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from gpubench import spec  # noqa: E402

torch.set_num_threads(2)

CELLS = ("qwen2.5-3b.gwt2-f32.b64s256",
         "qwen3-moe-30b-a3b-l6.gwt2-f32.b32s256")


def small(name: str, **config) -> spec.Cell:
    """Cell ``name`` with its model cut to 2 layers of width 64 (vocab
    512, 8 experts top-2) and 2 rows of 32 tokens a microbatch."""
    cell = spec.load(name)
    c = dict(cell.config)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=512, remat=False)
    if c.get("num_experts"):
        c.update(num_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=64)
    c.update(config)
    cell.config = c
    cell.traffic = dict(cell.traffic, batch=2 * cell.traffic["accum"],
                        seq=32)
    return cell

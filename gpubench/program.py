"""The system under test: the objects of the port's training launcher
(``repro_torch.launch.train``), built from a cell's files.  This module is
the benchmark's only way into the program: the model configuration, the
optimizer of ``make_optimizer``, the step of ``make_train_step`` and the
loop of ``TrainLoop``, with the weights and batches the benchmark made,
and the readings of its state that the check compares."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

# the port's fields named by a configuration file's published keys
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "vocab_size": "vocab", "tie_word_embeddings": "tie_embeddings",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "torch_dtype": "dtype", "num_experts": "n_experts",
          "num_experts_per_tok": "top_k",
          "moe_intermediate_size": "d_ff_expert",
          "capacity_factor": "capacity_factor", "qkv_bias": "qkv_bias",
          "qk_norm": "qk_norm", "remat": "remat"}


def model_config(c: dict):
    """The port's ``ModelConfig`` of configuration file ``c``: the port's
    entry for ``c["port_arch"]`` with every size the file gives."""
    from repro_torch import configs
    from repro_torch.models import lm
    kw = {f: c[k] for k, f in FIELDS.items() if k in c}
    if "head_dim" not in c:
        kw["head_dim"] = c["hidden_size"] // c["num_attention_heads"]
    kw["d_ff"] = 0 if c.get("num_experts", 0) else c["intermediate_size"]
    cfg = configs.get_config(c["port_arch"]).with_(**kw)
    fixed = c.get("as_run", {}).get("router_aux_loss_coef")
    if cfg.n_experts and lm.AUX_COEF != fixed:
        raise ValueError(f"the program's load-balance coefficient is "
                         f"{lm.AUX_COEF}; the configuration records "
                         f"{fixed} as run")
    return cfg


def layout_of(cfg) -> Dict[str, tuple]:
    """The program's parameter tree: path -> (shape, dtype)."""
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths
    paths, leaves = flatten_with_paths(lm.abstract_params(cfg))
    return {p: (tuple(t.shape), t.dtype) for p, t in zip(paths, leaves)}


class Program:
    """The step, its optimizer and the loop over them, as the launcher
    builds them; ``wrap_step`` and ``wrap_update`` (each ``fn -> fn``) see
    every call of the step and of ``optimizer.update``."""

    def __init__(self, cfg, traffic: dict, source, device, *,
                 wrap_step: Callable = None, wrap_update: Callable = None,
                 log=print, state_dtype: Optional[torch.dtype] = None):
        from repro_torch.launch.train import make_optimizer
        from repro_torch.models import module_for
        from repro_torch.runtime.fault_tolerance import TrainLoop
        opt_kw = dict(traffic["optimizer"])
        name = opt_kw.pop("name")
        if state_dtype is not None:
            opt_kw["state_dtype"] = state_dtype
        self.optimizer = make_optimizer(
            name, traffic["lr"], traffic["schedule_steps"],
            state_codec=traffic["codec"], **opt_kw)
        opt = self.optimizer
        if wrap_update is not None:
            opt = opt._replace(update=wrap_update(opt.update))
        step = module_for(cfg).make_train_step(cfg, opt,
                                               accum_steps=traffic["accum"])
        if wrap_step is not None:
            step = wrap_step(step)
        self.loop = TrainLoop(step, source, device=device,
                              log_every=traffic["log_every"], log=log)

    def run(self, params, opt_state, start: int, end: int):
        return self.loop.run(params, opt_state, start_step=start,
                             num_steps=end)

    def first_moments(self, params, opt_state) -> Dict[str, float]:
        """Each leaf's ``|m|`` after the first step, decoded from the
        stored state, over ``1 - b1``: the first gradient as the moments
        got it (GWT's band, or the whole leaf)."""
        from repro_torch.optim.base import flatten_with_paths
        paths = flatten_with_paths(params)[0]
        per_leaf = self.optimizer.engine.to_legacy(opt_state,
                                                   params)["leaves"]
        out = {}
        for i, path in enumerate(paths):
            m = per_leaf[f"{i:06d}"]["host"]["m"]
            if isinstance(m, dict):    # blocked int8: codes and scales
                m = dequant(m["q"], m["scale"])
            out[path] = norm(m) / (1 - 0.9)
        return out


def dequant(q: torch.Tensor, scale: torch.Tensor, block: int = 64):
    """Blocked int8 codes times their block's scale, flat order."""
    flat = q.reshape(-1).float()
    n = flat.numel()
    nb = scale.numel()
    pad = torch.nn.functional.pad(flat, (0, nb * block - n))
    return (pad.view(nb, block) * scale.view(nb, 1).float()).reshape(-1)[:n]


@torch.no_grad()
def norm(x: torch.Tensor) -> float:
    flat = x.reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), 1 << 26):
        total += float(torch.sum(flat[i:i + (1 << 26)].double() ** 2))
    return math.sqrt(total)

"""Where the int8 loss drift between the port and the JAX package comes
from, on llama-60m-smoke (6 steps, ``warmup_cosine(0.01, 6)``, GWT-2 with
int8 state).  Not collected by pytest; run on the CPU with::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_int8_drift.py

It prints, per seed (model init and data stream):

* ``grads``: the two models' gradient difference at step 1, relative to
  each leaf's largest element (max and median over leaves);
* ``same-grads``: both optimizers fed the JAX model's gradients along the
  JAX run: codes off by one per step, and the port's loss at its
  parameters against JAX's at its own (max over the 6 steps);
* ``loops``: the port's loop against the JAX loop, per-step loss gaps;
* ``control``: the JAX loop against itself with each step's gradients
  times ``1 + REL * N(0, 1)``, per-step loss gaps.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import flat_numpy, port_model, to_torch

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

STEPS = 6
JCFG, TCFG = jconfigs.get_smoke("llama-60m"), configs.get_smoke("llama-60m")


def _jax_opt():
    return jax_gwt(lr=jax_warmup_cosine(0.01, STEPS), impl="jnp",
                   state_codec="int8")


def _value_grad():
    return jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(JCFG, p, b)))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss(tree, batch):
    return float(lm.loss_fn(TCFG, tree, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}))


def grads(seed):
    jp, model = port_model(JCFG, TCFG, seed=seed)
    tree = model.tree()
    batch = JaxSyntheticLM(64, 16, 4, seed).batch(0)
    _, g = _value_grad()(jp, _jbatch(batch))
    paths, leaves = flatten_with_paths(tree)
    tg = dict(zip(paths, torch.autograd.grad(
        lm.loss_fn(TCFG, tree, {k: torch.from_numpy(v)
                                for k, v in batch.items()}), leaves)))
    rel = [float(np.abs(tg[p].detach().numpy() - w).max()
                 / max(np.abs(w).max(), 1e-30))
           for p, w in flat_numpy(g).items()]
    return max(rel), float(np.median(rel))


def same_grads(seed):
    jp, model = port_model(JCFG, TCFG, seed=seed)
    tp = model.tree()
    jopt = _jax_opt()
    topt = gwt(lr=warmup_cosine(0.01, STEPS), state_codec="int8")
    js, ts = jopt.init(jp), topt.init(tp)
    value_grad, jupd = _value_grad(), jax.jit(jopt.update)
    data = JaxSyntheticLM(64, 16, 4, seed)
    codes_off, loss_gap = [], 0.0
    for k in range(STEPS):
        batch = data.batch(k)
        jloss, g = value_grad(jp, _jbatch(batch))
        with torch.no_grad():
            loss_gap = max(loss_gap, abs(_port_loss(tp, batch)
                                         - float(jloss)))
        gf = flat_numpy(g)
        jp, js = jupd(g, js, jp)
        tp, ts = topt.update(unflatten(list(gf), [to_torch(v)
                                                  for v in gf.values()]),
                             ts, tp)
        jflat, tflat = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
        codes_off.append(sum(
            int((tflat[p].numpy().astype(np.int32)
                 != w.astype(np.int32)).sum())
            for p, w in jflat.items() if p.endswith("/q")))
    return codes_off, loss_gap


def loops(seed):
    jp, model = port_model(JCFG, TCFG, seed=seed)
    jopt = _jax_opt()
    jloop = JaxTrainLoop(jlm.make_train_step(JCFG, jopt), None,
                         JaxSyntheticLM(64, 16, 4, seed), log_every=3,
                         log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=STEPS)
    topt = gwt(lr=warmup_cosine(0.01, STEPS), state_codec="int8")
    tree = model.tree()
    tloop = TrainLoop(lm.make_train_step(TCFG, topt),
                      SyntheticLM(64, 16, 4, seed), device="cpu",
                      log_every=3, log=lambda s: None)
    _, _, tlosses = tloop.run(tree, topt.init(tree), num_steps=STEPS)
    return np.abs(np.array(tlosses) - np.array(jlosses))


def control(seed, rel):
    runs = []
    for pert in (0.0, rel):
        jp, _ = port_model(JCFG, TCFG, seed=seed)
        jopt = _jax_opt()
        js = jopt.init(jp)
        value_grad, jupd = _value_grad(), jax.jit(jopt.update)
        data = JaxSyntheticLM(64, 16, 4, seed)
        rng = np.random.RandomState(99)
        losses = []
        for k in range(STEPS):
            loss, g = value_grad(jp, _jbatch(data.batch(k)))
            losses.append(float(loss))
            if pert:
                g = jax.tree.map(lambda a: a * (1 + pert * jnp.asarray(
                    rng.randn(*a.shape).astype(np.float32))), g)
            jp, js = jupd(g, js, jp)
        runs.append(losses)
    return np.abs(np.array(runs[0]) - np.array(runs[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--rel", type=float, default=4e-7)
    args = ap.parse_args()
    torch.set_num_threads(2)
    fmt = lambda xs: " ".join(f"{x:.2e}" for x in xs)
    for seed in range(args.seeds):
        gmax, gmed = grads(seed)
        print(f"seed {seed} grads: rel diff max {gmax:.2e} median "
              f"{gmed:.2e}")
        off, gap = same_grads(seed)
        print(f"seed {seed} same-grads: codes off per step {off}, loss gap "
              f"max {gap:.2e}")
        print(f"seed {seed} loops: {fmt(loops(seed))}")
        print(f"seed {seed} control rel {args.rel:g}: "
              f"{fmt(control(seed, args.rel))}", flush=True)


if __name__ == "__main__":
    main()

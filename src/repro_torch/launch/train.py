"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --optimizer gwt --level 2 --steps 200 --batch 16 --seq 256 \
        [--host adam|adam_mini|muon] [--state-codec int8] \
        [--data synthetic|bytes|corpus --corpus-dir D --workers N] \
        [--eval-every K --eval-batches B] \
        [--ckpt-dir D --ckpt-every N --resume]

``--optimizer`` is ``gwt`` (with ``--host``, ``--level``, ``--alpha``) or
one of the full-rank baselines ``adam``, ``adam_mini``, ``muon``, ``sgd``;
every choice runs under a warmup-cosine schedule peaking at ``--lr`` and
takes ``--state-codec`` and ``--resume``.  The JAX package's low-rank
families are not ported yet.

Data (the JAX package's sources, batch ``i`` bitwise the same):
``--data synthetic`` (the default), ``bytes`` (this repo's ``src/**/*.py``)
or ``corpus`` over a directory built by ``python -m
repro_torch.data.build_corpus``; the model's vocab grows to the corpus
tokenizer's and never shrinks.  ``--workers N`` loads batches in N worker
processes (0: a prefetch thread); the stream is the same for any N.
``--eval-every K`` evaluates the held-out loss and perplexity over
``--eval-batches`` batches every K steps (the corpus eval split, or a
disjoint seed stream of the other sources).

Runs on CUDA unless ``--device cpu`` is given; without a card and without
``--device cpu`` it raises instead of falling back to the CPU.

Data parallel (the JAX package's ``--dp-reduce`` path)::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch llama-60m \
        --dp-reduce compressed --dp-level 2 [--dp-detail-dtype bfloat16] \
        [--dp-error-feedback]

Each rank takes its contiguous rows of the global batch; the gradients are
reduced by ``distributed.compression`` over NCCL (gloo with ``--device
cpu``).  Without ``torchrun`` the run is one rank, and ``--dp-reduce`` still
splits, narrows and reconstructs every gradient.  Only rank 0 logs and
writes checkpoints.

Fault tolerance: with ``--ckpt-dir`` the loop checkpoints every
``--ckpt-every`` steps and at the end, in the JAX package's format;
SIGTERM -> checkpoint at the next chunk boundary -> clean exit; a restart
with ``--resume`` continues from the latest committed step with the data
stream aligned, bitwise as if it had not stopped.  A checkpoint written
under the other ``--state-codec`` is transcoded on resume; one in the JAX
package's legacy per-leaf layout is migrated into buckets (and transcoded
to ``int8`` under ``--state-codec int8``).  The manifest records the data
source, its order seed and a corpus's content hash; a resume on another
data stream refuses.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import configs, optim
from repro_torch.checkpoint.manager import CheckpointManager, \
    StructureMismatch
from repro_torch.data.eval import make_lm_evaluator
from repro_torch.data.pipeline import make_source
from repro_torch.data.store import TokenStore
from repro_torch.distributed import compression
from repro_torch.launch.mesh import DPContext, init_dp
from repro_torch.models import lm
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths, tree_map
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop


def make_optimizer(name: str, lr: float, steps: int, **kw) -> optim.Optimizer:
    return optim.make(name, lr=warmup_cosine(lr, steps), **kw)


class TrainResult(NamedTuple):
    params: Any
    opt_state: Any
    losses: List[float]
    step_ms: Optional[float]   # steady-state wall time per step
    start_step: int = 0        # the step the run resumed from
    # per-rank gradient-reduction bytes per step with --dp-reduce, and the
    # exact f32 reduction's (compression.tree_wire_bytes)
    wire_bytes: Optional[Tuple[int, int]] = None
    evals: Tuple[Tuple[int, float], ...] = ()   # (step, eval loss)
    watchdog: Optional[dict] = None            # StepWatchdog.summary()


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    return device


def _meta(tree):
    """The shapes and dtypes of a tensor tree, on the ``meta`` device."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _check_ef_world(ckpt: CheckpointManager, ef, world: int) -> None:
    """The residues come first in flatten order; a checkpoint whose first
    leaves are residues of another rank count cannot be resumed."""
    want = [tuple(e.shape[1:]) for e in flatten_with_paths(ef)[1]]
    saved = [tuple(l["shape"]) for l in ckpt.manifest()["leaves"]]
    saved = saved[:len(want)]
    if len(saved) == len(want) and all(
            s[1:] == w for s, w in zip(saved, want)) \
            and saved[0][0] != world:
        raise StructureMismatch(
            f"checkpoint in {ckpt.dir} holds error-feedback residues of "
            f"{saved[0][0]} data-parallel ranks; this run has {world}")


def resume(ckpt: CheckpointManager, params, opt_state, build_optimizer,
           codec: str, data_meta: dict, device, log=print,
           dp: Optional[DPContext] = None):
    """Restore ``{"params", "opt"}`` from the latest checkpoint.  A state
    saved under another codec is restored in its own layout and transcoded
    to ``codec``.  With error feedback (``opt_state = {"opt", "dp_ef"}``)
    the checkpoint holds every rank's residues, ``(D, *shape)``, and this
    rank takes its own row; another rank count raises
    :class:`StructureMismatch`.  ``build_optimizer(codec)`` builds this
    run's optimizer under a codec.  Returns ``(params, opt_state,
    step)``."""
    saved_data = ckpt.saved_run().get("data")
    if saved_data is not None:
        for k in ("kind", "corpus_hash", "order_seed"):
            if k in saved_data and saved_data[k] != data_meta.get(k):
                raise SystemExit(
                    f"--resume provenance mismatch: checkpoint in {ckpt.dir} "
                    f"was trained with data {k}={saved_data[k]!r}, this run "
                    f"has {data_meta.get(k)!r}; refusing to continue on a "
                    f"different data stream")
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    inner, ef = compression.split_ef(opt_state)
    if ef is not None:
        _check_ef_world(ckpt, ef, world)

    def like(opt):
        if ef is None:
            return opt
        return {"opt": opt, "dp_ef": tree_map(
            lambda e: torch.empty((world, *e.shape[1:]), device="meta"),
            ef)}

    def own_row(opt):
        if ef is None:
            return opt
        return {"opt": opt["opt"], "dp_ef": tree_map(
            lambda e: e[rank:rank + 1].contiguous(), opt["dp_ef"])}

    try:
        state, start = ckpt.restore(None, {"params": params,
                                           "opt": like(inner)},
                                    device=device)
        return state["params"], own_row(state["opt"]), start
    except StructureMismatch as e:
        # two recoverable mismatches: the JAX package's legacy per-leaf
        # layout ("'leaves'" in its treedef) and a codec change
        saved_codec = ckpt.saved_run().get("state_codec", "f32")
        legacy = "'leaves'" in ckpt.manifest().get("treedef", "")
        if legacy and ef is not None:
            raise StructureMismatch(
                f"checkpoint in {ckpt.dir} holds the legacy per-leaf "
                f"optimizer state, which predates --dp-error-feedback; "
                f"resume it once without error feedback to migrate "
                f"it") from e
        if not legacy and saved_codec == codec:
            raise StructureMismatch(
                f"checkpoint in {ckpt.dir} does not match this run's "
                f"optimizer state; did --optimizer/--level/--host, "
                f"--dp-reduce or the model config change since it was "
                f"saved? ({e})") from e
    if legacy:
        return _migrate(ckpt, params, build_optimizer, codec, device, log)
    saved_opt = build_optimizer(saved_codec)
    state, start = ckpt.restore(
        None, {"params": params, "opt": like(saved_opt.init(_meta(params)))},
        device=device)
    saved_inner, _ = compression.split_ef(state["opt"])
    new_opt = build_optimizer(codec)
    converted = engine.transcode(saved_inner, state["params"], saved_opt,
                                 new_opt)
    if ef is not None:
        converted = {"opt": converted, "dp_ef": state["opt"]["dp_ef"]}
    log(f"transcoded optimizer state {saved_codec} -> {codec}")
    return state["params"], own_row(converted), start


def _migrate(ckpt: CheckpointManager, params, build_optimizer, codec: str,
             device, log):
    """Restore a legacy per-leaf checkpoint, regroup it into buckets and,
    for another codec than f32, transcode it (legacy states are raw f32).
    Returns ``(params, opt_state, step)``."""
    f32_opt = build_optimizer("f32")
    state, start = ckpt.restore(
        None, {"params": params,
               "opt": f32_opt.engine.legacy_like(params)},
        device=device)
    opt_state = f32_opt.engine.migrate_legacy(state["opt"], state["params"])
    log("migrated legacy per-leaf optimizer state -> buckets")
    if codec != "f32":
        opt_state = engine.transcode(opt_state, state["params"], f32_opt,
                                     build_optimizer(codec))
        log(f"transcoded optimizer state f32 -> {codec}")
    return state["params"], opt_state, start


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--optimizer", default="gwt",
                    choices=list(optim.REGISTRY))
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--host", default="adam",
                    choices=["adam", "adam_mini", "muon"],
                    help="the host optimizer GWT runs on the approximation "
                         "band (--optimizer gwt)")
    ap.add_argument("--state-codec", default="f32", choices=["f32", "int8"],
                    help="optimizer-state substrate: 'f32' raw moments, "
                         "'int8' blocked 8-bit moments (one absmax scale per "
                         "64 elements, stochastic rounding); --resume "
                         "transcodes a checkpoint of the other codec")
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "bytes", "corpus"])
    ap.add_argument("--corpus-dir", default="",
                    help="with --data corpus: a directory built by "
                         "`python -m repro_torch.data.build_corpus` (mmap "
                         "token shards + index)")
    ap.add_argument("--workers", type=int, default=0,
                    help="data-loader worker PROCESSES (shared-memory "
                         "transport; 0 = in-process prefetch thread).  "
                         "Batches are a pure function of the step, so the "
                         "worker count never changes the stream and may "
                         "change across resumes")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate held-out loss/perplexity every N steps "
                         "(corpus eval split, or a disjoint stream of the "
                         "other sources); 0 disables")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dp-reduce", default="none",
                    choices=["none", "exact", "compressed"],
                    help="data-parallel gradient reduction over the ranks "
                         "of torchrun (one rank without it): 'exact' = f32 "
                         "sum, 'compressed' = wavelet split (f32 "
                         "approximation band, --dp-detail-dtype details)")
    ap.add_argument("--dp-level", type=int, default=2,
                    help="wavelet levels for --dp-reduce compressed "
                         "(wire bytes ~ 1/2^l f32 + (1-1/2^l) detail)")
    ap.add_argument("--dp-detail-dtype", default="bfloat16",
                    choices=list(compression.WIRE_DTYPES),
                    help="detail-band wire dtype for --dp-reduce compressed")
    ap.add_argument("--dp-error-feedback", action="store_true",
                    help="with --dp-reduce compressed: keep each rank's "
                         "quantization residue and add it back before the "
                         "next reduction")
    ap.add_argument("--shard-params", default="none",
                    choices=["auto", "none"],
                    help="'none' (the only layout of the port): parameters "
                         "and optimizer state replicated on every rank")
    args = ap.parse_args(argv)
    if args.shard_params == "auto":
        ap.error("--shard-params auto (the JAX package's FSDP layout) is "
                 "not ported; use --shard-params none")
    try:
        dp_spec = compression.DPReduceSpec.parse(
            args.dp_reduce, args.dp_level, args.dp_detail_dtype,
            error_feedback=args.dp_error_feedback)
    except ValueError as e:
        ap.error(str(e))
    if dp_spec is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ap.error("a run of several ranks needs --dp-reduce exact or "
                 "compressed")
    if args.data == "corpus" and not args.corpus_dir:
        ap.error("--data corpus needs --corpus-dir (build one with "
                 "`python -m repro_torch.data.build_corpus`)")

    device = resolve_device(args.device)
    dp = init_dp(device) if dp_spec is not None else None
    try:
        return _train(args, dp_spec, dp, device if dp is None else dp.device)
    finally:
        if dp is not None:
            dp.close()


def _train(args, dp_spec, dp: Optional[DPContext], device) -> TrainResult:
    rank0 = dp is None or dp.rank == 0
    log = print if rank0 else (lambda s: None)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.data == "corpus":
        # the embedding table must cover the corpus tokenizer: vocab is a
        # property of the data, so the model grows to fit (never shrinks)
        corpus_vocab = TokenStore(args.corpus_dir).vocab_size
        if corpus_vocab > cfg.vocab:
            log(f"model vocab {cfg.vocab} -> {corpus_vocab} (corpus "
                f"tokenizer)")
            cfg = cfg.with_(vocab=corpus_vocab)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.init(cfg, generator, device)
    params = model.tree()
    n_params = sum(p.numel() for p in model.parameters())

    source = make_source(args.data, cfg.vocab, args.seq, args.batch,
                         seed=args.seed, corpus_dir=args.corpus_dir or None)

    def build_optimizer(codec: str):
        kw = {"state_codec": codec}
        if args.optimizer == "gwt":
            kw.update(level=args.level, alpha=args.alpha, host=args.host)
        return make_optimizer(args.optimizer, args.lr, args.steps, **kw)

    optimizer = build_optimizer(args.state_codec)
    opt_state = optimizer.init(params)

    # exact bytes of this optimizer's state; f32 Adam keeps m and v per
    # parameter plus the int32 step
    mem_bytes = engine.state_bytes(opt_state)
    adam_f32_bytes = 8 * n_params + 4
    log(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"optimizer={args.optimizer} codec={args.state_codec} "
        f"opt_state={mem_bytes/2**20:.2f}MiB "
        f"({adam_f32_bytes/max(mem_bytes, 1):.1f}x smaller than "
        f"full-Adam f32 {adam_f32_bytes/2**20:.2f}MiB)")
    wire = None
    if dp_spec is not None:
        wire = (compression.tree_wire_bytes(params, dp_spec),
                compression.tree_wire_bytes(params, None))
        log(f"dp_reduce={args.dp_reduce} dp={dp.world} "
            f"wire={wire[0]/2**20:.1f}MiB/step vs exact "
            f"{wire[1]/2**20:.1f}MiB ({wire[1]/wire[0]:.2f}x)")
        if dp_spec.error_feedback:
            opt_state = {"opt": opt_state,
                         "dp_ef": compression.ef_init(params)}

    # data provenance, stamped into every manifest: a resume on another
    # data stream fails instead of training on
    data_meta = {"kind": args.data, "order_seed": args.seed}
    if args.data == "corpus":
        data_meta["corpus_hash"] = source.store.corpus_hash
    run_meta = {"data": data_meta, "state_codec": args.state_codec}
    ckpt = CheckpointManager(args.ckpt_dir, run_meta=run_meta) \
        if args.ckpt_dir else None
    start = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        params, opt_state, start = resume(
            ckpt, params, opt_state, build_optimizer, args.state_codec,
            data_meta, device, log=log, dp=dp)
        params = lm.LM(cfg, params).tree()
        log(f"resumed from step {start}")

    train_step = lm.make_train_step(cfg, optimizer, accum_steps=args.accum,
                                    dp_reduce=dp_spec, dp=dp)
    evaluator = None
    if args.eval_every:
        eval_src = make_source(args.data, cfg.vocab, args.seq, args.batch,
                               seed=args.seed,
                               corpus_dir=args.corpus_dir or None,
                               split="eval")
        evaluator = make_lm_evaluator(cfg, lm, eval_src,
                                      n_batches=args.eval_batches,
                                      device=device)
    loop = TrainLoop(train_step, source, device=device, ckpt=ckpt,
                     ckpt_every=args.ckpt_every, log_every=args.log_every,
                     log=log, dp=dp, num_workers=args.workers,
                     evaluator=evaluator, eval_every=args.eval_every)
    params, opt_state, losses = loop.run(params, opt_state, start_step=start,
                                         num_steps=args.steps)
    wd = loop.watchdog.summary()
    if wd["dispatch_s_per_step"] is not None:
        log(f"dispatch={wd['dispatch_s_per_step'] * 1e3:.1f}ms/step "
            f"blocked={(wd['blocked_s_per_step'] or 0) * 1e3:.1f}ms/step "
            f"incidents={wd['incidents']}")
    if losses:
        k = max(1, len(losses) // 10)
        log(f"final loss (mean of last {k}): {sum(losses[-k:]) / k:.4f}")
    evals = () if evaluator is None else tuple(evaluator.history)
    if evals:
        s, v = evals[-1]
        log(f"final eval (step {s}): loss={v:.4f} "
            f"ppl={math.exp(min(v, 30.0)):.2f}")
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return TrainResult(params, opt_state, losses, step_ms, start, wire,
                       evals, wd)


if __name__ == "__main__":
    main()

"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --optimizer gwt --level 2 --steps 200 --batch 16 --seq 256 \
        [--host adam|adam_mini|muon] [--state-codec int8] \
        [--data synthetic|bytes|corpus --corpus-dir D --workers N] \
        [--eval-every K --eval-batches B] \
        [--ckpt-dir D --ckpt-every N --resume] [--metrics-dir M]

    # LoRA: pre-train a base, then fine-tune adapters on it (frozen base)
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --finetune lora --lora-rank 8 --lora-alpha 16 --base-ckpt D \
        [--state-codec int8] [--ckpt-dir FT]

``--optimizer`` is ``gwt`` (with ``--host``, ``--level``, ``--alpha``), one
of the full-rank baselines ``adam``, ``adam_mini``, ``muon``, ``sgd``, or
one of the low-rank baselines ``galore``, ``apollo``, ``fira``,
``adarankgrad``, ``rso`` (rank 1/4 of each weight's smaller side,
``--alpha``, as the JAX launcher builds them: APOLLO too gets ``--alpha``,
not its constructor's 1.0); every choice runs under a warmup-cosine
schedule peaking at ``--lr`` and takes ``--state-codec`` and ``--resume``.

Data (the JAX package's sources, batch ``i`` bitwise the same):
``--data synthetic`` (the default), ``bytes`` (this repo's ``src/**/*.py``)
or ``corpus`` over a directory built by ``python -m
repro_torch.data.build_corpus``; the model's vocab grows to the corpus
tokenizer's and never shrinks.  ``--workers N`` loads batches in N worker
processes (0: a prefetch thread); the stream is the same for any N.
``--eval-every K`` evaluates the held-out loss and perplexity over
``--eval-batches`` batches every K steps (the corpus eval split, or a
disjoint seed stream of the other sources).

``--finetune lora`` wraps the parameters into ``{"base", "lora"}``
(``models/lora.py``): adapters of ``--lora-rank`` on every attention and
MLP projection, drawn from ``fold_in(key(seed), 777)``, trained through the
merged forward with the base frozen (no optimizer state, no gradient); the
optimizer's own rule takes the adapters.  ``--base-ckpt`` restores the
base's parameters from a checkpoint first.  The manifest records the rank
and alpha, from which serving merges the adapters at load.

Every assigned ``--arch`` trains: the decoder-only LMs (attention, MoE,
mamba, xLSTM blocks) and the encoder-decoder ``seamless-m4t-large-v2``
(``models/encdec.py``), whose batches carry ``seq // 4`` seeded frame
embeddings a row (``data.pipeline.WithEncoderFrames``).

``--metrics-dir M`` turns on the telemetry of DESIGN.md §12: JSONL records
in ``M/metrics.jsonl`` (a ``run`` header, the launcher's log lines under
the JAX launcher's kinds, ``run_meta``, a ``train_step`` record per step
with the optimizer's on-device taps joined to each chunk's last step,
``eval`` and the watchdog's records) and the loop's spans in
``M/trace.json`` (Chrome trace events: open it in Perfetto).  The taps
(band energy, limiter clips, update and gradient norms, int8 saturation)
need a bucketed optimizer and are not taken with ``--dp-reduce`` or LoRA,
as in the JAX launcher.  Unset, nothing is recorded and the step is the
untapped one.  Under ``torchrun`` only rank 0 writes them.

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

``--mesh`` lays the ranks out as the JAX launcher's does: ``8`` (data),
``4x2`` (data, model) or ``2x4x2`` (pod, data, model); its size must be
``WORLD_SIZE``, and without it every rank runs over ``data``.
``--dp-reduce`` needs a one-axis mesh.  ``--shard-params auto`` (the
default; acts only with ``--dp-reduce``) keeps each rank's shards of the
parameters and of GWT's state between steps, placed by the FSDP rule table
(``distributed/sharding.py``: every ``embed`` dimension over ``data`` where
it divides); the step gathers the parameters whole, and the optimizer one
bucket's state at a time, so the numbers are ``none``'s, bitwise.
Checkpoints hold whole arrays and resume under either layout and any rank
count (error-feedback residues excepted).  The ``memory`` line logs the
whole state's bytes, a ``shard`` line each rank's.

A mesh of several ranks without ``--dp-reduce`` runs the exact f32 mean
over its data axes.  Along ``model`` (``--mesh 1x2``, ``2x2``) every model
family runs the tensor-parallel step (``distributed/tensor_parallel.py``;
the JAX launcher leaves that axis to GSPMD): each rank holds, between steps
and inside them, its ``model`` shards of the rule table
(``sharding.tp_rules``: attention heads, self- and cross-attention alike,
MLP columns and rows, the vocab rows of the embedding and head, the
experts or, where their count does not divide, each expert's hidden
columns, and the ``inner`` channels of mamba and of xLSTM's mLSTM and
sLSTM blocks), and of GWT's state; the update gathers one bucket at a time
whole over ``model`` and runs K1/K2 on it.  The numbers are the replicated
step's within rounding (row-parallel sums, split norms, the vocab-split
loss).  The ``shard`` line logs each rank's bytes.  ``--finetune lora``
takes the same step: the frozen base is placed as the whole model's
parameters are, each adapter pair from its weight's placement
(``sharding.lora_pair_shardings``: ``b`` split with a column-parallel
weight, ``a`` with a row-parallel one, both with the experts), each rank
merges its base shard with its slice of the delta (``lora.merge(...,
tp=)``), and the update gathers each adapter bucket whole for K1/K2 and
never touches the base; the ``shard`` line then gives the base's and the
adapters' bytes apart.  ``--base-ckpt`` restores the whole base, and each
rank cuts its shards.  ``--dist-backend gloo`` runs
several ranks on one card (with ``LOCAL_RANK=0`` for each): a check, not a
way to train.

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
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import configs, obs, optim
from repro_torch.checkpoint.manager import CheckpointManager, \
    StructureMismatch
from repro_torch.core import prng
from repro_torch.data.eval import make_lm_evaluator
from repro_torch.data.pipeline import WithEncoderFrames, make_source
from repro_torch.data.store import TokenStore
from repro_torch.distributed import compression, sharding, tensor_parallel
from repro_torch.launch.mesh import (DPContext, env_world, init_mesh,
                                     parse_mesh)
from repro_torch.models import encoder_frames, lora, module_for
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
    # ``params`` and ``opt_state`` are whole (gathered at the end under
    # --shard-params auto); ``local`` is this rank's ``{"params", "opt"}``
    # as it held them, on the ``meta`` device
    local: Any = None


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    return device


def _meta(tree):
    """The shapes and dtypes of a tensor tree, on the ``meta`` device."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(tree)[1])


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
           codec: str, data_meta: dict, device, log,
           dp: Optional[DPContext] = None, shardings=None):
    """Restore ``{"params", "opt"}`` from the latest checkpoint.  A state
    saved under another codec is restored in its own layout and transcoded
    to ``codec``.  With error feedback (``opt_state = {"opt", "dp_ef"}``)
    the checkpoint holds every rank's residues, ``(D, *shape)``, and this
    rank takes its own row; another rank count raises
    :class:`StructureMismatch`.  ``build_optimizer(codec)`` builds an
    unplaced optimizer under a codec; ``log(msg, kind=..., **fields)``
    (``Telemetry.log``'s signature) reports a migration or a transcode.
    ``shardings`` (the run's ``{"params", "opt"}`` placements, shaped like
    the checkpoint's tree; None: unplaced): ``params`` and ``opt_state``
    are this rank's shards, the checkpoint's whole leaves are cut to them
    as they are read.  Returns ``(params, opt_state, step)``."""
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
    # the checkpoint holds whole leaves: restore into their shapes
    psh, osh = (None, None) if shardings is None else (
        shardings["params"], compression.split_ef(shardings["opt"])[0])
    params = sharding.full_meta(params, psh)
    inner = sharding.full_meta(inner, osh)
    place = None if shardings is None else sharding.leaf_shard(shardings)

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

    def placed(p, opt):
        # a converted state is whole: cut it to this run's layout
        return sharding.shard_tree(p, psh), sharding.shard_tree(opt, osh)

    try:
        state, start = ckpt.restore(None, {"params": params,
                                           "opt": like(inner)},
                                    device=device, place=place)
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
        p, opt, start = _migrate(ckpt, params, build_optimizer, codec,
                                 device, log)
        return (*placed(p, opt), start)
    saved_opt = build_optimizer(saved_codec)
    state, start = ckpt.restore(
        None, {"params": params, "opt": like(saved_opt.init(params))},
        device=device)
    saved_inner, _ = compression.split_ef(state["opt"])
    new_opt = build_optimizer(codec)
    converted = engine.transcode(saved_inner, state["params"], saved_opt,
                                 new_opt)
    log(f"transcoded optimizer state {saved_codec} -> {codec}",
        kind="transcode", src=saved_codec, dst=codec)
    p, converted = placed(state["params"], converted)
    if ef is not None:
        converted = {"opt": converted, "dp_ef": state["opt"]["dp_ef"]}
    return p, own_row(converted), start


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
    log("migrated legacy per-leaf optimizer state -> buckets",
        kind="migrate")
    if codec != "f32":
        opt_state = engine.transcode(opt_state, state["params"], f32_opt,
                                     build_optimizer(codec))
        log(f"transcoded optimizer state f32 -> {codec}", kind="transcode",
            src="f32", dst=codec)
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
    ap.add_argument("--finetune", default="none", choices=["none", "lora"],
                    help="'lora': freeze the base model (no optimizer "
                         "state, no gradient) and train low-rank adapters "
                         "on the attention/MLP projections; composes with "
                         "any --optimizer/--state-codec")
    ap.add_argument("--lora-rank", type=int, default=8)
    ap.add_argument("--lora-alpha", type=float, default=16.0)
    ap.add_argument("--base-ckpt", default="",
                    help="checkpoint dir holding the pre-trained base "
                         "(params-only restore); with --finetune lora the "
                         "restored weights become the frozen base")
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
    ap.add_argument("--mesh", default="",
                    help="device mesh over the torchrun ranks, e.g. '8' "
                         "(data), '4x2' (data, model) or '2x4x2' (pod, "
                         "data, model); its size must be WORLD_SIZE.  "
                         "Empty: every rank over 'data'")
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
    ap.add_argument("--shard-params", default="auto",
                    choices=["auto", "none"],
                    help="with --dp-reduce only (no effect otherwise): "
                         "'auto' keeps each rank's shards of the parameters "
                         "and of GWT's state, placed by the FSDP rule table "
                         "(distributed/sharding.py); 'none' keeps them "
                         "replicated (classic DP).  The numbers are the "
                         "same")
    ap.add_argument("--dist-backend", default="auto",
                    choices=["auto", "nccl", "gloo"],
                    help="process-group backend: 'auto' is NCCL on CUDA and "
                         "gloo on the CPU; 'gloo' on CUDA lets several ranks "
                         "share one card (LOCAL_RANK=0 each)")
    ap.add_argument("--metrics-dir", default="",
                    help="telemetry directory (DESIGN.md §12): JSONL metric "
                         "records -> <dir>/metrics.jsonl, Chrome-trace spans "
                         "-> <dir>/trace.json (open in Perfetto), and the "
                         "on-device training-dynamics taps (band energy, "
                         "clip rate, update norms) joined to the step "
                         "records.  Unset: nothing recorded, the untapped "
                         "step")
    args = ap.parse_args(argv)
    try:
        dp_spec = compression.DPReduceSpec.parse(
            args.dp_reduce, args.dp_level, args.dp_detail_dtype,
            error_feedback=args.dp_error_feedback)
    except ValueError as e:
        ap.error(str(e))
    try:
        mesh_shape = parse_mesh(args.mesh) if args.mesh else None
    except ValueError as e:
        ap.error(str(e))
    world = env_world()
    if dp_spec is not None and mesh_shape is not None \
            and len(mesh_shape) > 1:
        ap.error(f"--dp-reduce {args.dp_reduce} needs a pure-DP mesh "
                 f"(single-axis '--mesh 8'), not {args.mesh!r}: the "
                 f"manual DP reduction cannot leave ('model',) to the "
                 f"partitioner — drop --dp-reduce for TP meshes")
    if mesh_shape is not None and math.prod(mesh_shape) != world:
        ap.error(f"--mesh {args.mesh!r} holds {math.prod(mesh_shape)} "
                 f"devices but WORLD_SIZE is {world}: launch "
                 f"{math.prod(mesh_shape)} ranks (torchrun "
                 f"--nproc-per-node {math.prod(mesh_shape)}) or change "
                 f"--mesh")
    if dp_spec is None and world > 1 and mesh_shape is None:
        ap.error("a run of several ranks needs --dp-reduce exact or "
                 "compressed, or a --mesh")
    if args.finetune == "lora" and dp_spec is not None:
        ap.error("--finetune lora does not compose with --dp-reduce yet "
                 "(the sharded step reduces full-tree gradients; adapter-"
                 "only reduction is future work) — drop --dp-reduce")
    if args.data == "corpus" and not args.corpus_dir:
        ap.error("--data corpus needs --corpus-dir (build one with "
                 "`python -m repro_torch.data.build_corpus`)")

    device = resolve_device(args.device)
    dp = mesh = None
    if dp_spec is not None or mesh_shape is not None:
        dp, mesh = init_mesh(device, mesh_shape,
                             None if args.dist_backend == "auto"
                             else args.dist_backend)
    try:
        # one process writes the records and the trace: rank 0 (the JAX
        # launcher is one process); the other ranks keep the null Telemetry
        if dp is None or dp.process_rank == 0:
            obs.configure(args.metrics_dir or None,
                          run={"cmd": "train", "arch": args.arch,
                               "optimizer": args.optimizer,
                               "level": args.level, "host": args.host,
                               "state_codec": args.state_codec,
                               "steps": args.steps, "seed": args.seed,
                               "finetune": args.finetune})
        return _train(args, dp_spec, dp, mesh,
                      device if dp is None else dp.device)
    finally:
        # writes <metrics-dir>/trace.json and closes the JSONL sink (a no-op
        # for the null Telemetry)
        obs.shutdown()
        if dp is not None:
            dp.close()


def _train(args, dp_spec, dp: Optional[DPContext], mesh,
           device) -> TrainResult:
    rank0 = dp is None or dp.process_rank == 0
    tel = obs.get()
    say = print if rank0 else (lambda s: None)

    def log(msg: str, kind: str = "log", **fields) -> None:
        # the JAX launcher's tel.log: printed and recorded under ``kind``
        if rank0:
            tel.log(msg, kind=kind, **fields)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.data == "corpus":
        # the embedding table must cover the corpus tokenizer: vocab is a
        # property of the data, so the model grows to fit (never shrinks)
        corpus_vocab = TokenStore(args.corpus_dir).vocab_size
        if corpus_vocab > cfg.vocab:
            log(f"model vocab {cfg.vocab} -> {corpus_vocab} (corpus "
                f"tokenizer)", kind="vocab_grow", old=cfg.vocab,
                new=corpus_vocab)
            cfg = cfg.with_(vocab=corpus_vocab)
    # the encoder-decoder stack (seamless) or the decoder-only LM
    mod = module_for(cfg)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = mod.init(cfg, generator, device)
    wrap = type(model)   # holds a restored tree as parameters
    params = model.tree()
    n_params = sum(p.numel() for p in model.parameters())
    del model   # the tree holds the tensors; placing them must free them
    if args.base_ckpt:
        base, base_step = CheckpointManager(args.base_ckpt).restore_params(
            None, params)
        params = wrap(cfg, base).tree()
        log(f"restored pre-trained base from {args.base_ckpt} (step "
            f"{base_step})", kind="base_restore", ckpt=args.base_ckpt,
            step=base_step)
    finetune = args.finetune == "lora"

    # encoder-decoder batches carry the audio front end's frame stub
    # (WithEncoderFrames): seq // 4 frames of d_model a row
    enc_kw = encoder_frames(cfg, args.seq)
    source = make_source(args.data, cfg.vocab, args.seq, args.batch,
                         seed=args.seed, corpus_dir=args.corpus_dir or None,
                         **enc_kw)

    # a mesh of several ranks without --dp-reduce runs the exact mean over
    # its data axes; --shard-params auto places only the --dp-reduce step's
    # trees, as the JAX launcher pins a layout only there
    step_spec = dp_spec
    if step_spec is None and dp is not None and dp.processes > 1:
        step_spec = compression.DPReduceSpec.parse("exact")
    shardings = tp = None
    if dp_spec is not None and args.shard_params == "auto":
        shardings = sharding.train_step_shardings(
            cfg, mod, source.batch(0), mesh, optimizer_name=args.optimizer,
            level=args.level, host=args.host, shard_params=True,
            state_codec=args.state_codec)
    elif dp is not None and dp.model_world > 1:
        # every family; under LoRA the {"base", "lora"} form: the base
        # placed as the whole model's parameters, each adapter pair from
        # its weight's
        tp = tensor_parallel.from_dp(dp)
        shardings = sharding.tp_step_shardings(
            cfg, mod, source.batch(0), mesh,
            lora_rank=args.lora_rank if finetune else None,
            optimizer_name=args.optimizer, level=args.level,
            host=args.host, state_codec=args.state_codec)

    def build_optimizer(codec: str, placed: bool = False):
        kw = {"state_codec": codec}
        state_sh = None
        if args.optimizer == "gwt":
            kw.update(level=args.level, alpha=args.alpha, host=args.host)
            if placed and shardings is not None:
                state_sh = shardings.opt["buckets"]
        elif args.optimizer in optim.LOWRANK:
            kw.update(rank_frac=0.25, alpha=args.alpha)
        if finetune:
            opt = make_optimizer(args.optimizer, args.lr, args.steps, **kw)
            return lora.wrap_optimizer(opt, state_shardings=state_sh)
        if state_sh is not None:
            kw["state_shardings"] = state_sh
        return make_optimizer(args.optimizer, args.lr, args.steps, **kw)

    if finetune:
        params = lora.inject(params, args.lora_rank,
                             prng.fold_in(prng.key(args.seed), 777))
        n_adapter = sum(t.numel()
                        for t in flatten_with_paths(params["lora"])[1])
        log(f"finetune=lora rank={args.lora_rank} alpha={args.lora_alpha} "
            f"adapters={n_adapter/1e3:.1f}K params "
            f"({n_adapter/max(n_params, 1):.4f} of base)", kind="finetune",
            rank=args.lora_rank, alpha=args.lora_alpha,
            adapter_params=n_adapter)
    optimizer = build_optimizer(args.state_codec, placed=True)
    opt_state = optimizer.init(params)
    opt_sh = None if shardings is None else shardings.opt

    # exact bytes of this optimizer's whole state (the same under either
    # layout); f32 Adam keeps m and v per parameter plus the int32 step
    mem_bytes = sharding.full_bytes(opt_state, opt_sh)
    adam_f32_bytes = 8 * n_params + 4
    log(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"optimizer={args.optimizer} codec={args.state_codec} "
        f"opt_state={mem_bytes/2**20:.2f}MiB "
        f"({adam_f32_bytes/max(mem_bytes, 1):.1f}x smaller than "
        f"full-Adam f32 {adam_f32_bytes/2**20:.2f}MiB)", kind="memory",
        params=n_params, opt_state_bytes=mem_bytes,
        adam_f32_bytes=adam_f32_bytes)
    wire = None
    if step_spec is not None:
        # only the adapters' gradients are reduced under LoRA
        grad_tree = params["lora"] if finetune else params
        wire = (compression.tree_wire_bytes(grad_tree, step_spec),
                compression.tree_wire_bytes(grad_tree, None))
        log(f"dp_reduce={args.dp_reduce if dp_spec else 'exact'} "
            f"dp={dp.world} wire={wire[0]/2**20:.1f}MiB/step vs exact "
            f"{wire[1]/2**20:.1f}MiB ({wire[1]/wire[0]:.2f}x)",
            kind="dp_wire", wire_bytes=wire[0], exact_bytes=wire[1])
    ef_on = dp_spec is not None and dp_spec.error_feedback
    if ef_on:
        opt_state = {"opt": opt_state, "dp_ef": compression.ef_init(params)}
    ckpt_sh = None
    if shardings is not None:
        params = sharding.shard_tree(params, shardings.params)
        rank_p = _nbytes(params)
        rank_s = engine.state_bytes(compression.split_ef(opt_state)[0])
        lora_kw, lora_msg = {}, ""
        if finetune:
            lora_kw = {"base_rank_bytes": _nbytes(params["base"]),
                       "lora_rank_bytes": _nbytes(params["lora"])}
            lora_msg = (f" (base {lora_kw['base_rank_bytes']/2**20:.2f}MiB"
                        f" + adapters {lora_kw['lora_rank_bytes']/2**20:.2f}"
                        f"MiB)")
        log(f"shard_params=auto mesh={dict(mesh.shape)}"
            f"{' tensor_parallel=model' if tp is not None else ''} "
            f"params/rank={rank_p/2**20:.2f}MiB{lora_msg} opt_state/rank="
            f"{rank_s/2**20:.2f}MiB", kind="shard",
            params_rank_bytes=rank_p, opt_state_rank_bytes=rank_s,
            **lora_kw)
        # placements shaped like a checkpoint's tree (residues unplaced)
        ckpt_sh = {"params": shardings.params,
                   "opt": {"opt": opt_sh, "dp_ef": None} if ef_on
                   else opt_sh}

    # data provenance, stamped into every manifest: a resume on another
    # data stream fails instead of training on
    data_meta = {"kind": args.data, "order_seed": args.seed}
    if args.data == "corpus":
        data_meta["corpus_hash"] = (
            source.source if isinstance(source, WithEncoderFrames)
            else source).store.corpus_hash
    run_meta = {"data": data_meta, "state_codec": args.state_codec}
    if finetune:
        # serving reads this to merge the adapters into the base at load
        run_meta["finetune"] = {"mode": "lora", "rank": args.lora_rank,
                                "alpha": args.lora_alpha}
    ckpt = CheckpointManager(args.ckpt_dir, run_meta=run_meta) \
        if args.ckpt_dir else None
    # the metrics stream carries the provenance the manifest records
    tel.emit("run_meta", **run_meta)
    start = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        params, opt_state, start = resume(
            ckpt, params, opt_state, build_optimizer, args.state_codec,
            data_meta, device, log=log, dp=dp, shardings=ckpt_sh)
        params = wrap(cfg, params).tree()
        log(f"resumed from step {start}", kind="resume", step=start)

    tap_step = None
    # the user's --dp-reduce: without it the step takes the exact mean
    # over several ranks by itself (lm.make_train_step)
    step_kw = dict(accum_steps=args.accum, dp_reduce=dp_spec, dp=dp,
                   shardings=shardings, tp=tp)
    if finetune:
        train_step = lora.make_train_step(mod, cfg, optimizer,
                                          rank=args.lora_rank,
                                          alpha=args.lora_alpha, **step_kw)
    else:
        train_step = mod.make_train_step(cfg, optimizer, **step_kw)
        # the tapped step runs each chunk's last step (TrainLoop), on any
        # mesh; the --dp-reduce step has no tapped channel, as in the JAX
        # launcher
        if args.metrics_dir and dp_spec is None \
                and optimizer.tapped_update is not None:
            tap_step = mod.make_train_step(cfg, optimizer, taps=True,
                                           **step_kw)
    evaluator = None
    if args.eval_every:
        eval_src = make_source(args.data, cfg.vocab, args.seq, args.batch,
                               seed=args.seed,
                               corpus_dir=args.corpus_dir or None,
                               split="eval", **enc_kw)
        eval_mod = lora.loss_module(mod, args.lora_alpha, args.lora_rank) \
            if finetune else mod
        evaluator = make_lm_evaluator(cfg, eval_mod, eval_src,
                                      n_batches=args.eval_batches,
                                      device=device)
    loop = TrainLoop(train_step, source, device=device, ckpt=ckpt,
                     ckpt_every=args.ckpt_every, log_every=args.log_every,
                     log=say, dp=dp, num_workers=args.workers,
                     evaluator=evaluator, eval_every=args.eval_every,
                     tap_step=tap_step, shardings=ckpt_sh)
    # hand the state over to the loop: a name kept in this frame would pin
    # the first state's moments of every rule that returns new tensors
    # (the plain Adam of the embedding and an untied head) for the whole
    # run, where the JAX package donates them
    handoff = [opt_state]
    del opt_state
    params, opt_state, losses = loop.run(params, handoff.pop(),
                                         start_step=start,
                                         num_steps=args.steps)
    # the result holds whole trees, as a checkpoint does
    local = _meta({"params": params, "opt": opt_state})
    if ckpt_sh is not None:
        whole = sharding.gather_tree({"params": params, "opt": opt_state},
                                     ckpt_sh)
        params, opt_state = whole["params"], whole["opt"]
        del whole
    wd = loop.watchdog.summary()
    if wd["dispatch_s_per_step"] is not None:
        say(f"dispatch={wd['dispatch_s_per_step'] * 1e3:.1f}ms/step "
            f"blocked={(wd['blocked_s_per_step'] or 0) * 1e3:.1f}ms/step "
            f"incidents={wd['incidents']}")
    if losses:
        k = max(1, len(losses) // 10)
        log(f"final loss (mean of last {k}): {sum(losses[-k:]) / k:.4f}",
            kind="final_loss", loss=sum(losses[-k:]) / k, window=k)
    evals = () if evaluator is None else tuple(evaluator.history)
    if evals:
        s, v = evals[-1]
        log(f"final eval (step {s}): loss={v:.4f} "
            f"ppl={math.exp(min(v, 30.0)):.2f}", kind="final_eval", step=s,
            loss=float(v))
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return TrainResult(params, opt_state, losses, step_ms, start, wire,
                       evals, wd, local)


if __name__ == "__main__":
    main()

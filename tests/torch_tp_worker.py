"""One rank of the port's tensor-parallel checks along the ``model`` mesh
axis (``test_torch_tp_ranks.py`` starts two or four of these; not a test
module).

    RANK=r WORLD_SIZE=W MASTER_ADDR=localhost \
        python tests/torch_tp_worker.py OUT

Imports neither JAX nor the JAX package.  First, on a ``1xW`` mesh, the
loss and the gradients of every config of :data:`GRAD_ARCHS` (f32) from the
port's seeded init, this rank computing on its shards and the gradients
gathered whole (``grads_<W>_<rank>.pt``): the dense and MoE decoders,
jamba (mamba, attention and MoE blocks), xLSTM (mLSTM and sLSTM) and the
encoder-decoder stack; and of :data:`LORA_GRAD_ARCHS` the LoRA loss and
the adapters' gradients (``"lora <arch>"``), from adapters with a nonzero
``b``.  Then every scenario of
:data:`SCENARIOS` ``[W]`` through the launcher, each on its own port,
writing ``OUT/<name>_<rank>.pt``: the losses, the whole parameters and
optimizer state the launcher returns, and this rank's shards as it held
them (``TrainResult.local``, shapes and dtypes); the tapped scenarios
(:func:`taps_dir`) also leave rank 0's records with the optimizer taps
under ``OUT/taps_<name>``.  With the gradients, on the same ``1xW``
mesh, :func:`engine_runs` drives the engine's ``tapped_update`` and
``update`` with ``param_shardings=`` (``engine_<W>_<rank>.pt``).  Rank 0
takes each
group's rendezvous port just before the group forms (a port taken when
the processes start may be another test's by then) and hands it to the
other ranks through ``OUT/port_<W>_<i>``.
"""

import contextlib
import os
import socket
import sys
import time

import torch

torch.set_num_threads(1)

from repro_torch import configs, optim  # noqa: E402
from repro_torch.distributed import sharding, tensor_parallel  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import init_mesh  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import lora, module_for  # noqa: E402
from repro_torch.optim.base import (flatten_with_paths, tree_map,  # noqa: E402
                                    unflatten)

# the MoE smokes run in f32: in bf16 a router near-tie may pick another
# expert under the other layout's rounding, which no tolerance bounds
ODD_MOE = "qwen2-moe-a2.7b-odd"   # E_pad 9: tensor parallelism per expert
_EXTRA = {
    "qwen3-moe-30b-a3b-f32": lambda get: get("qwen3-moe-30b-a3b").with_(
        name="qwen3-moe-30b-a3b-f32", dtype="float32"),
    "qwen2-moe-a2.7b-f32": lambda get: get("qwen2-moe-a2.7b").with_(
        name="qwen2-moe-a2.7b-f32", dtype="float32"),
    ODD_MOE: lambda get: get("qwen2-moe-a2.7b").with_(
        name=ODD_MOE, expert_padding=3, dtype="float32"),
}
# the recurrent and encoder-decoder smokes, f32 (jamba's MoE routes)
for _a in ("jamba-v0.1-52b", "xlstm-350m", "seamless-m4t-large-v2"):
    _EXTRA[f"{_a}-f32"] = lambda get, a=_a: get(a).with_(
        name=f"{a}-f32", dtype="float32")
JAMBA, XLSTM, SEAMLESS = ("jamba-v0.1-52b-f32", "xlstm-350m-f32",
                          "seamless-m4t-large-v2-f32")
# qwen2.5's smoke in f32: at 1x4 its 4 query heads split and its 2 KV
# heads do not (the K/V projections and their adapters stay whole)
QWEN_F32 = "qwen2.5-3b-f32"
_EXTRA[QWEN_F32] = lambda get: get("qwen2.5-3b").with_(name=QWEN_F32,
                                                       dtype="float32")

# LoRA: the launcher's rank and alpha.  inject draws b as zeros; the LoRA
# runs here start from a nonzero b (nonzero_b), so that a's gradient, the
# one a missing all-reduce would leave partial on a column-parallel
# weight, is nonzero from the first step
LORA_RANK, LORA_ALPHA = 8, 16.0
LORA = ["--finetune", "lora"]
B_SCALE = 0.02


def _b_drawn(inject):
    def drawn(params, rank, key):
        tree = inject(params, rank, key)
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for path, t in zip(*flatten_with_paths(tree["lora"])):
                if path.endswith("/b") and t.device.type != "meta":
                    t.copy_(B_SCALE * torch.randn(t.shape, generator=g))
        return tree
    return drawn


@contextlib.contextmanager
def nonzero_b():
    """``lora.inject`` (what the launcher calls) draws each ``b`` from a
    seeded normal of scale :data:`B_SCALE`, in flatten order."""
    inject = lora.inject
    lora.inject = _b_drawn(inject)
    try:
        yield
    finally:
        lora.inject = inject


def lora_tree(cfg):
    """The seeded init with adapters (:func:`nonzero_b`'s ``b``), drawn
    from the launcher's key (``--seed 0``)."""
    return _b_drawn(lora.inject)(grad_params(cfg), LORA_RANK,
                                 prng.fold_in(prng.key(0), 777))


@contextlib.contextmanager
def extra_configs():
    """``configs.get_smoke`` also knows the ids of :data:`_EXTRA`."""
    get = configs.get_smoke

    def smoke(name):
        return _EXTRA[name](get) if name in _EXTRA else get(name)
    configs.get_smoke = smoke
    try:
        yield
    finally:
        configs.get_smoke = get


def smoke_cfg(arch, **kw):
    with extra_configs():
        return configs.get_smoke(arch).with_(**kw)


SMOKE = ["--smoke", "--log-every", "1", "--device", "cpu"]
LLAMA = ["--arch", "llama-60m", "--batch", "4", "--seq", "16"]


def _arch(arch, steps=3):
    return ["--arch", arch, "--batch", "4", "--seq", "64", "--steps",
            str(steps)]


def taps_dir(name):
    """``--metrics-dir`` of a tapped scenario: rank 0 writes the records,
    the optimizer taps on every step (``--log-every 1``) among them."""
    return ["--metrics-dir", "{out}/taps_" + name]


# name -> launcher arguments (the checkpoint and metrics directories under
# OUT)
SCENARIOS = {
    2: {
        "llama": [*LLAMA, "--steps", "6", "--mesh", "1x2", "--ckpt-dir",
                  "{out}/ck_tp", "--ckpt-every", "3",
                  *taps_dir("llama")],
        "llama_resume": [*LLAMA, "--steps", "6", "--mesh", "1x2",
                         "--ckpt-dir", "{out}/ck_one", "--ckpt-every", "3",
                         "--resume"],
        "llama_int8": [*LLAMA, "--steps", "3", "--mesh", "1x2",
                       "--state-codec", "int8", *taps_dir("llama_int8")],
        "qwen": [*_arch("qwen2.5-3b"), "--mesh", "1x2"],
        "gemma": [*_arch("gemma2-9b"), "--mesh", "1x2"],
        "moe_ep": [*_arch("qwen3-moe-30b-a3b-f32"), "--mesh", "1x2",
                   *taps_dir("moe_ep")],
        "moe_etp": [*_arch(ODD_MOE), "--mesh", "1x2"],
        # checkpoints at steps 2 and 4 (held to one rank's, and restored
        # at world 1 bitwise); the resume restores one rank's step 2 and
        # runs no step (its whole trees are the checkpoint's, bitwise)
        "jamba": [*_arch(JAMBA, 4), "--mesh", "1x2", "--ckpt-dir",
                  "{out}/ck_jamba_tp", "--ckpt-every", "2",
                  *taps_dir("jamba")],
        "jamba_resume": [*_arch(JAMBA, 2), "--mesh", "1x2", "--ckpt-dir",
                         "{out}/ck_jamba_one", "--resume"],
        "xlstm": [*_arch(XLSTM), "--mesh", "1x2", *taps_dir("xlstm")],
        "seamless": [*_arch(SEAMLESS), "--mesh", "1x2",
                     *taps_dir("seamless")],
        # LoRA: checkpoints at steps 2 and 4 (restored at world 1); the
        # resume restores one rank's step 2 and runs steps 3-4
        "lora": [*LLAMA, "--steps", "4", "--mesh", "1x2", *LORA,
                 "--ckpt-dir", "{out}/ck_lora_tp", "--ckpt-every", "2"],
        "lora_resume": [*LLAMA, "--steps", "4", "--mesh", "1x2", *LORA,
                        "--ckpt-dir", "{out}/ck_lora_one", "--resume"],
        "lora_int8": [*LLAMA, "--steps", "3", "--mesh", "1x2", *LORA,
                      "--state-codec", "int8"],
    },
    4: {
        "llama_2x2": [*LLAMA, "--steps", "3", "--mesh", "2x2",
                      *taps_dir("llama_2x2")],
        "qwen_1x4": [*_arch("qwen2.5-3b"), "--mesh", "1x4"],
        # 2 heads over 4 ranks: mLSTM computes every head and keeps its
        # channels, sLSTM's recurrence runs replicated
        "xlstm_1x4": [*_arch(XLSTM), "--mesh", "1x4"],
        "jamba_2x2": [*_arch(JAMBA), "--mesh", "2x2"],
        # LoRA where the K/V projections stay whole (qwen2.5) and where
        # the attention does (llama's 2 heads), int8
        "lora_qwen_1x4": [*_arch(QWEN_F32), "--mesh", "1x4", *LORA],
        "lora_int8_1x4": [*LLAMA, "--steps", "3", "--mesh", "1x4", *LORA,
                          "--state-codec", "int8"],
        # the exact mean of the adapters' gradients over two data ranks
        "lora_2x2": [*LLAMA, "--steps", "3", "--mesh", "2x2", *LORA],
    },
}

# the configs whose loss and gradients are gathered (f32), at 1x2 and 1x4
GRAD_ARCHS = ["llama-60m", "qwen2.5-3b", "gemma2-9b", "gemma3-27b",
              "deepseek-67b", "qwen2-vl-72b", "qwen3-moe-30b-a3b-f32",
              "qwen2-moe-a2.7b-f32", ODD_MOE, JAMBA, XLSTM, SEAMLESS]
GRAD_SEQ = 64
# the configs whose LoRA loss and adapter gradients are gathered (f32): a
# weight split by columns, by rows (xLSTM's wq over inner), by experts
# (qwen3-moe under EP), inside each expert (the odd MoE), left whole
# (qwen2.5's K/V at 1x4, llama's attention at 1x4), and the
# encoder-decoder stack's self- and cross-attention
LORA_GRAD_ARCHS = ["llama-60m", QWEN_F32, "qwen3-moe-30b-a3b-f32", ODD_MOE,
                   JAMBA, XLSTM, SEAMLESS]


def grad_batch(cfg, seed=1):
    """Tokens and labels (2, GRAD_SEQ), and for the encoder-decoder stack
    the frames' stub (2, GRAD_SEQ // 4, d_model)."""
    g = torch.Generator().manual_seed(seed)
    out = {k: torch.randint(0, cfg.vocab, (2, GRAD_SEQ), generator=g,
                            dtype=torch.int32)
           for k in ("tokens", "labels")}
    if cfg.arch_class == "encdec":
        out["enc_embeds"] = torch.randn(2, GRAD_SEQ // 4, cfg.d_model,
                                        generator=g)
    return out


def grad_params(cfg):
    return module_for(cfg).init(cfg, torch.Generator().manual_seed(0),
                                "cpu").tree()


PORT_TIMEOUT_S = 600


def rendezvous_port(out, world, rank, i):
    """Group ``i``'s port, taken by rank 0 just before the group forms and
    read by the others from ``OUT/port_<world>_<i>``."""
    path = os.path.join(out, f"port_{world}_{i}")
    if rank == 0:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        with open(path + ".tmp", "w") as f:
            f.write(port)
        os.replace(path + ".tmp", path)
        return port
    deadline = time.monotonic() + PORT_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} within {PORT_TIMEOUT_S} s")
        time.sleep(0.05)
    with open(path) as f:
        return f.read()


def grads(out, rank, world):
    """Loss and whole gradients of each :data:`GRAD_ARCHS` config on a
    ``1xW`` mesh."""
    os.environ["MASTER_PORT"] = rendezvous_port(out, world, rank, 0)
    dp, mesh = init_mesh(torch.device("cpu"), (1, world))
    res = {}
    try:
        tp = tensor_parallel.from_dp(dp)
        for arch in GRAD_ARCHS:
            cfg = smoke_cfg(arch, dtype="float32")
            mod = module_for(cfg)
            batch = grad_batch(cfg)
            sh = sharding.tp_step_shardings(cfg, mod, batch, mesh).params
            local = sharding.shard_tree(grad_params(cfg), sh)
            paths, leaves = flatten_with_paths(local)
            loss = mod.loss_fn(cfg, local, batch, tp=tp)
            g = torch.autograd.grad(loss, leaves)
            res[arch] = (loss.detach(),
                         sharding.gather_tree(unflatten(paths, g), sh))
        for arch in LORA_GRAD_ARCHS:
            cfg = smoke_cfg(arch, dtype="float32")
            mod = module_for(cfg)
            batch = grad_batch(cfg)
            sh = sharding.tp_step_shardings(cfg, mod, batch, mesh,
                                            lora_rank=LORA_RANK).params
            local = sharding.shard_tree(lora_tree(cfg), sh)
            lora.freeze(local)
            paths, leaves = flatten_with_paths(local["lora"])
            loss = lora.loss_module(mod, LORA_ALPHA, LORA_RANK,
                                    sh["lora"]).loss_fn(cfg, local, batch,
                                                        tp=tp)
            g = torch.autograd.grad(loss, leaves)
            res[f"lora {arch}"] = (loss.detach(), sharding.gather_tree(
                unflatten(paths, g), sh["lora"]))
        eng = {codec: engine_runs(mesh, codec) for codec in ENGINE_CODECS}
    finally:
        dp.close()
    torch.save(res, os.path.join(out, f"grads_{world}_{rank}.pt"))
    torch.save(eng, os.path.join(out, f"engine_{world}_{rank}.pt"))


# the engine's tapped update on a tensor-parallel layout: llama-60m's
# smoke (f32), two steps of seeded gradients, each codec
ENGINE_ARCH, ENGINE_STEPS, ENGINE_CODECS = "llama-60m", 2, ("f32", "int8")


def engine_optimizer(codec, state_shardings=None):
    return optim.make("gwt", lr=1e-2, level=2, state_codec=codec,
                      state_shardings=state_shardings)


def engine_grads(cfg, k):
    """Step ``k``'s whole f32 gradients, seeded, of the parameters'
    shapes."""
    g = torch.Generator().manual_seed(100 + k)
    return tree_map(lambda t: 1e-2 * torch.randn(t.shape, generator=g),
                    grad_params(cfg))


def engine_runs(mesh, codec):
    """:data:`ENGINE_STEPS` steps of ``tapped_update(...,
    param_shardings=)`` and of ``update(..., param_shardings=)`` from the
    seeded init, this rank holding its shards of ``tp_step_shardings``'s
    layout (the state placed by the optimizer): each run's local
    parameters and state, its whole trees gathered at the end, and the
    tapped run's taps of every step."""
    cfg = smoke_cfg(ENGINE_ARCH, dtype="float32")
    sh = sharding.tp_step_shardings(cfg, module_for(cfg), grad_batch(cfg),
                                    mesh, state_codec=codec)
    runs = {}
    for key in ("tapped", "update"):
        opt = engine_optimizer(codec, sh.opt["buckets"])
        whole = grad_params(cfg)
        state = opt.init(whole)
        params = sharding.shard_tree(whole, sh.params)
        del whole
        taps = []
        for k in range(ENGINE_STEPS):
            g = sharding.shard_tree(engine_grads(cfg, k), sh.params)
            if key == "tapped":
                params, state, t = opt.tapped_update(
                    g, state, params, param_shardings=sh.params)
                taps.append(t)
            else:
                params, state = opt.update(g, state, params,
                                           param_shardings=sh.params)
        runs[key] = {"params": params, "opt": state, "taps": taps,
                     "whole": sharding.gather_tree(
                         {"params": params, "opt": state},
                         {"params": sh.params, "opt": sh.opt})}
    return runs


def main(out):
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    grads(out, rank, world)
    with extra_configs():
        for i, (name, argv) in enumerate(SCENARIOS[world].items(), 1):
            os.environ["MASTER_PORT"] = rendezvous_port(out, world, rank, i)
            with nonzero_b() if name.startswith("lora") \
                    else contextlib.nullcontext():
                r = train.main(SMOKE + [a.format(out=out) for a in argv])
            torch.save({"losses": r.losses, "params": r.params,
                        "opt": r.opt_state,
                        "local": tree_map(lambda t: (tuple(t.shape), t.dtype),
                                          r.local)},
                       os.path.join(out, f"{name}_{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])

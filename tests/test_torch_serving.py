"""The port's serving stack on the CPU: the slot-paged KV arena with int8
pages, chunked prefill, the continuous-batching engine, the launcher, and
the train -> checkpoint -> serve round trip, twins of
``tests/test_serving.py`` held against the port's own dense ``generate``;
and against the JAX package: the engine's greedy tokens and per-step
logits, ``quant_entries`` bitwise, a checkpoint the JAX package trained,
the arena bytes, and the telemetry records (twin of
``tests/test_obs.py::test_serve_engine_emits_request_records_at_
retirement``).

Parameters are JAX-initialised (or JAX-trained) and carried over by
``repro_torch.interop``.  Tolerances: a paged schedule computes the same
attention as the dense path over a longer, masked cache, so on the CPU the
greedy tokens are equal; chunked against single-shot prefill logits keep
the reference test's ``atol=1e-3, rtol=1e-4``; the port's step logits
against the JAX package's, on weights GWT trained for 4 steps, to 16 f32
spacings of their largest magnitude (``TOL_STEP``): twice the 8 that
``test_torch_lm.py`` gives the train logits, because a chunk's scores run
over the gathered pages and its causal offset in another order again
(measured 11.5 on a chunk's prompt positions, 2.5-5.5 on decode ticks).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, port_model, spacings, to_torch

from repro import configs as jconfigs, optim as joptim
from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm
from repro.serve import engine as jengine, kv as jkv
from repro_torch import configs, interop, obs, optim
from repro_torch.checkpoint.manager import CheckpointManager, \
    StructureMismatch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch.serve import ensure_capacity, generate, pad_cache
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.sink import MemorySink
from repro_torch.optim.base import flatten_with_paths
from repro_torch.serve import kv as kv_lib
from repro_torch.serve.engine import Engine, EngineConfig, Request

JCFG = jconfigs.get_smoke("llama-60m")
TCFG = configs.get_smoke("llama-60m")
TOL_STEP = 16


@pytest.fixture(scope="module")
def smoke():
    """JAX-initialised llama-60m-smoke params, and the port's copy."""
    jp, model = port_model(JCFG, TCFG, seed=0)
    return jp, model.tree()


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A checkpoint the JAX package trained (GWT-2, 4 steps) and saved, its
    params, and the JAX engine's greedy tokens for ``_requests(6)``."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    params = jlm.init(JCFG, jax.random.PRNGKey(6))
    opt = joptim.make("gwt", lr=1e-2, level=2)
    state = opt.init(params)
    data = JaxSyntheticLM(JCFG.vocab, 16, 2, seed=5)
    step = jax.jit(jlm.make_train_step(JCFG, opt))
    for i in range(4):
        params, state, _ = step(params, state, data.batch(i))
    JaxCheckpoints(d).save(4, {"opt": state, "params": params},
                           blocking=True)
    eng = jengine.Engine.from_checkpoint(JCFG, d,
                                         jengine.EngineConfig(**ECFG))
    reqs = _requests(6, jengine.Request)
    eng.run(reqs)
    return d, params, [r.generated for r in reqs]


ECFG = dict(num_slots=3, page_size=4, max_ctx=32, prefill_chunk=8)


def _ecfg(**kw):
    return EngineConfig(**dict(ECFG, **kw))


def _requests(n, cls=Request, seed=3, max_prompt=20, max_gen=8):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(
                0, TCFG.vocab, int(rng.randint(3, max_prompt))).tolist(),
                max_gen=int(rng.randint(1, max_gen + 1)))
            for i in range(n)]


def _dense(params, prompt, n, cfg=TCFG):
    return generate(cfg, params, torch.tensor([prompt]), n)[0].tolist()


def _free_list_recovered(eng):
    return sorted(eng.free_pages) == list(range(1, eng.num_pages))


# ---------------------------------------------------------------------------
# Paged substrate vs dense decode
# ---------------------------------------------------------------------------

def test_paged_decode_matches_dense(smoke):
    """Hand-driven paged chunk prefill + decode gives the dense
    prefill/decode greedy tokens (the prompt crosses page boundaries, the
    final chunk is short)."""
    _, params = smoke
    prompt = torch.from_numpy(
        np.random.RandomState(1).randint(0, TCFG.vocab, (1, 7)))
    GEN, PAGE, MP = 5, 4, 4
    ref = generate(TCFG, params, prompt, GEN)[0].tolist()
    pools = lm.init_paged_caches(TCFG, 1 + 2 * MP, PAGE, device="cpu")
    page_table = torch.zeros((2, MP), dtype=torch.int32)
    page_table[0, :3] = torch.tensor([1, 2, 3])
    chunk_step = lm.make_chunk_prefill_step(TCFG)
    decode_step = lm.make_paged_decode_step(TCFG)
    filled = 0
    for start in range(0, 7, PAGE):
        chunk = prompt[:, start:start + PAGE]
        last_logits, pools = chunk_step(params, pools, page_table[:1],
                                        torch.tensor([filled]), chunk)
        filled += chunk.shape[1]
    nxt = int(torch.argmax(last_logits[0, -1]))
    out = [nxt]
    lens = torch.tensor([7, 0], dtype=torch.int32)
    for _ in range(GEN - 1):
        tokens = torch.zeros((2, 1), dtype=torch.int64)
        tokens[0, 0] = nxt
        logits, pools = decode_step(params, pools, page_table, lens, tokens)
        lens[0] += 1
        nxt = int(torch.argmax(logits[0]))
        out.append(nxt)
    assert out == ref


def test_chunked_prefill_matches_single_shot_logits(smoke):
    """The last prompt position's logits from chunked paged prefill match
    the single-shot dense prefill's (same math, other summation order)."""
    _, params = smoke
    PLEN, CHUNK, PAGE = 40, 16, 8
    prompt = torch.from_numpy(
        np.random.RandomState(5).randint(0, TCFG.vocab, (1, PLEN)))
    ref_logits, _ = lm.make_prefill_step(TCFG)(params, {"tokens": prompt})
    MP = -(-(PLEN + 1) // PAGE)
    pools = lm.init_paged_caches(TCFG, 1 + MP, PAGE, device="cpu")
    pt = torch.arange(1, MP + 1, dtype=torch.int32)[None, :]
    chunk_step = lm.make_chunk_prefill_step(TCFG)
    filled = 0
    while filled < PLEN:
        chunk = prompt[:, filled:filled + CHUNK]
        pad = CHUNK - chunk.shape[1]
        if pad:      # fixed chunk shape: padded tail past the prompt end
            chunk = torch.nn.functional.pad(chunk, (0, pad))
        logits, pools = chunk_step(params, pools, pt,
                                   torch.tensor([filled]), chunk)
        filled += CHUNK - pad
    np.testing.assert_allclose(logits[0, (PLEN - 1) % CHUNK].numpy(),
                               ref_logits[0].numpy(), atol=1e-3, rtol=1e-4)


def test_padded_chunk_past_the_row_goes_to_trash(smoke):
    """A 19-token prompt in chunks of 8 over a 5-page row of 4: the last
    chunk's padded positions 20-23 lie past the row and go to the trash
    page, so the real entries at 16-18 survive and the prompt's last
    logits equal the single-shot prefill's (the JAX package clamps those
    positions onto the row's last page, over the real entries)."""
    _, params = smoke
    prompt = np.random.RandomState(0).randint(0, TCFG.vocab, 19)
    pools = lm.init_paged_caches(TCFG, 6, 4, device="cpu")
    pt = torch.arange(1, 6, dtype=torch.int32)[None]
    step = lm.make_chunk_prefill_step(TCFG)
    for start in (0, 8, 16):
        toks = torch.zeros((1, 8), dtype=torch.int64)
        piece = torch.from_numpy(prompt[start:start + 8])
        toks[0, :len(piece)] = piece
        logits, _ = step(params, pools, pt, torch.tensor([start]), toks)
    ref, _ = lm.make_prefill_step(TCFG)(
        params, {"tokens": torch.from_numpy(prompt)[None]})
    np.testing.assert_allclose(logits[0, 2].numpy(), ref[0].numpy(),
                               atol=1e-3, rtol=1e-4)
    page, off = kv_lib.chunk_dest(pt[0], torch.tensor(16), 8, 4)
    assert page.tolist() == [5, 5, 5, 5, kv_lib.TRASH_PAGE, 0, 0, 0]
    assert off.tolist() == [0, 1, 2, 3, 0, 1, 2, 3]


def test_int8_kv_quant_roundtrip_error_bounded():
    """Per-head absmax int8 entries dequantize within one quantum."""
    x = torch.from_numpy(
        np.random.RandomState(0).randn(6, 4, 16).astype(np.float32) * 3.0)
    q, scale = kv_lib.quant_entries(x)
    assert q.dtype == torch.int8 and scale.shape == (6, 4)
    back = q.float() * scale[..., None]
    assert ((back - x).abs() <= scale[..., None] + 1e-7).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_entries_bitwise_equal_reference(dtype):
    """Codes and scales equal the JAX package's bitwise, f32 and bf16
    entries, an all-zero head vector included."""
    x = np.random.RandomState(1).randn(5, 3, 2, 16).astype(np.float32) * 4
    x[1, 2, 0] = 0.0
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, js = jkv.quant_entries(jnp.asarray(x, jd))
    q, s = kv_lib.quant_entries(to_torch(x, getattr(torch, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


# ---------------------------------------------------------------------------
# Engine scheduling
# ---------------------------------------------------------------------------

def test_engine_continuous_and_static_match_dense(smoke):
    """Every request served under continuous batching (and static waves)
    generates exactly the dense single-request path's tokens."""
    _, params = smoke
    eng = Engine(TCFG, params, _ecfg())
    for static in (False, True):
        reqs = _requests(6)
        eng.reset()
        stats = eng.run(reqs, static=static)
        assert stats["requests"] == 6
        for r in reqs:
            assert r.generated == _dense(params, r.prompt, r.max_gen), \
                (static, r.rid)
        assert _free_list_recovered(eng)


def test_engine_open_loop_arrivals_respected(smoke):
    eng = Engine(TCFG, smoke[1], _ecfg(num_slots=2))
    reqs = _requests(4)
    for i, r in enumerate(reqs):
        r.arrival = 0.03 * i
    eng.run(reqs)
    for r in reqs:
        assert r.t_admit >= r.arrival - 1e-6
        assert r.t_done >= r.t_first >= r.t_admit


def test_engine_page_exhaustion_serializes_and_recovers(smoke):
    """A pool sized for about one request at a time forces head-of-line
    waiting: later requests admit only after earlier ones free their
    pages, the outputs stay right and the free list recovers."""
    _, params = smoke
    eng = Engine(TCFG, params, _ecfg(num_slots=2, max_ctx=24,
                                     num_pages=1 + 7))   # max_pages=6
    reqs = [Request(rid=i, prompt=list(range(5 + i, 15 + i)), max_gen=6)
            for i in range(3)]
    eng.run(reqs)
    for r in reqs:
        assert r.generated == _dense(params, r.prompt, r.max_gen)
    assert reqs[1].t_admit >= reqs[0].t_done - 1e-6
    assert reqs[2].t_admit >= reqs[1].t_done - 1e-6
    assert _free_list_recovered(eng)


def test_engine_int8_kv_greedy_close_to_f32(smoke):
    outs = {}
    for quant in (None, "int8"):
        eng = Engine(TCFG, smoke[1], _ecfg(num_slots=2, page_size=8,
                                           max_ctx=40, kv_quant=quant))
        reqs = _requests(4, seed=11, max_prompt=24, max_gen=10)
        eng.run(reqs)
        outs[quant] = [r.generated for r in reqs]
    total = match = 0
    for a, b in zip(outs[None], outs["int8"]):
        assert len(a) == len(b)
        total += len(a)
        match += sum(int(x == y) for x, y in zip(a, b))
    assert match / total >= 0.9, (match, total, outs)


def _truncate(ref, eos_id=None, stop_seqs=()):
    """Dense greedy tokens cut at the first EOS / stop-sequence tail
    (inclusive), else the full max_gen run."""
    out = []
    for t in ref:
        out.append(t)
        if eos_id is not None and t == eos_id:
            break
        if any(stop and len(out) >= len(stop)
               and out[-len(stop):] == list(stop) for stop in stop_seqs):
            break
    return out


def test_engine_eos_retires_slot_and_admits_queue(jax_trained):
    """A request that emits eos_id retires early, its pages free up and
    the next queued request takes the single slot; both outputs match the
    dense greedy path truncated at EOS.  (Trained weights: random ones
    repeat one token, so no EOS lands mid-generation.)"""
    params = _port_params(jax_trained[1])
    reqs = _requests(3, seed=7, max_prompt=16, max_gen=8)
    refs = [_dense(params, r.prompt, r.max_gen) for r in reqs]
    long0 = next(ref for ref in refs if len(ref) >= 4)
    eos = long0[len(long0) // 2]
    eng = Engine(TCFG, params, _ecfg(num_slots=1, eos_id=eos))
    eng.run(reqs)
    truncated_any = False
    for r, ref in zip(reqs, refs):
        want = _truncate(ref, eos_id=eos)
        assert r.generated == want, (r.rid, r.generated, want)
        truncated_any |= len(want) < len(ref)
        assert r.t_done >= 0
    assert truncated_any
    assert _free_list_recovered(eng)
    order = sorted(reqs, key=lambda r: r.t_admit)
    for a, b in zip(order, order[1:]):
        assert b.t_admit >= a.t_done - 1e-6


def test_engine_eos_on_first_token_retires_from_prefill(smoke):
    """EOS as the very first generated token: the slot retires straight
    from PREFILL without entering DECODE."""
    _, params = smoke
    req = Request(rid=0, prompt=list(range(3, 13)), max_gen=6)
    ref = _dense(params, req.prompt, 6)
    eng = Engine(TCFG, params, _ecfg(num_slots=2, max_ctx=24,
                                     eos_id=ref[0]))
    eng.run([req])
    assert req.generated == [ref[0]]
    assert _free_list_recovered(eng)


def test_engine_stop_sequence_retires(jax_trained):
    params = _port_params(jax_trained[1])
    req = Request(rid=0, prompt=list(range(5, 17)), max_gen=8)
    ref = _dense(params, req.prompt, 8)
    stop = tuple(ref[2:4])      # tail hit after the 4th token at the latest
    eng = Engine(TCFG, params, _ecfg(num_slots=2, stop_seqs=(stop,)))
    eng.run([req])
    want = _truncate(ref, stop_seqs=(stop,))
    assert req.generated == want and len(want) <= 4
    assert _free_list_recovered(eng)


def test_engine_rejects_unsupported_archs(smoke):
    for arch in ("gemma2-9b", "gemma3-27b"):       # sliding windows
        with pytest.raises(NotImplementedError, match="window"):
            Engine(configs.get_smoke(arch), smoke[1], EngineConfig())
    with pytest.raises(NotImplementedError, match="pattern"):
        Engine(TCFG.with_(pattern=("mamba",)), smoke[1], EngineConfig())
    with pytest.raises(NotImplementedError, match="multimodal rope"):
        Engine(TCFG.with_(mrope_sections=(2, 3, 3)), smoke[1],
               EngineConfig())
    with pytest.raises(ValueError, match="cannot hold"):
        Engine(TCFG, smoke[1], _ecfg(num_pages=4))


def test_arena_written_in_place(smoke, monkeypatch):
    """One arena for the engine's life: the pools' storage is the same
    before and after a run (and was written), and no tick builds another
    arena."""
    made = []
    real = lm.init_paged_caches
    monkeypatch.setattr(lm, "init_paged_caches",
                        lambda *a, **kw: made.append(1) or real(*a, **kw))
    for quant in (None, "int8"):
        eng = Engine(TCFG, smoke[1], _ecfg(kv_quant=quant))
        paths, leaves = flatten_with_paths(eng.pools)
        ptrs = [t.data_ptr() for t in leaves]
        before = [t.clone() for t in leaves]
        eng.warmup()
        eng.run(_requests(6))
        after = flatten_with_paths(eng.pools)[1]
        assert [t.data_ptr() for t in after] == ptrs
        assert all(a is b for a, b in zip(after, leaves))
        assert any(not torch.equal(a, b) for a, b in zip(after, before))
        assert not any(t.requires_grad for t in after)
    assert len(made) == 2


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def test_ensure_capacity_raises_on_undersized_cache(smoke):
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, TCFG.vocab, (2, 6)))
    _, cache = lm.make_prefill_step(TCFG)(smoke[1], {"tokens": tokens})
    # an unpadded prefill cache (depth 6) cannot take 4 decode writes
    with pytest.raises(ValueError, match="silently clamp"):
        ensure_capacity(cache, 10)
    padded = pad_cache(cache, 10)
    assert ensure_capacity(padded, 10) is padded
    assert padded["layers"]["b0"]["k"].shape[2] == 10
    # ring-buffer leaves (depth == window) are exempt by design
    win = {"k": torch.zeros(1, 4, 2, 8), "v": torch.zeros(1, 4, 2, 8)}
    ensure_capacity(win, 100, window=4)


def test_serve_main_on_the_cpu_and_its_metrics(tmp_path):
    stats = serve.main(["--smoke", "--device", "cpu", "--requests", "5",
                        "--prompt-len", "12", "--gen", "6", "--num-slots",
                        "2", "--kv-quant", "int8", "--metrics-dir",
                        str(tmp_path)])
    assert stats["requests"] == 5 and stats["mode"] == "continuous"
    ecfg = EngineConfig(num_slots=2, page_size=16, max_ctx=18,
                        kv_quant="int8")
    assert stats["kv_arena_bytes"] == kv_lib.pool_bytes(
        lm.init_paged_caches(TCFG, ecfg.resolved_num_pages(), 16, "int8",
                             device="meta"))
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run" and kinds.count("serve_request") == 5
    assert kinds[-2:] == ["serve_run", "serve_summary"]
    obs_trace.validate(json.load(open(tmp_path / "trace.json")))


def test_serve_main_refuses_the_cpu_fallback_and_lora(smoke, tmp_path):
    """No silent CPU fallback; ``--merge-lora`` on a checkpoint that holds
    no adapters raises instead of serving a wrong tree."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--device", "cuda"])
    CheckpointManager(str(tmp_path)).save(1, {"params": smoke[1]},
                                          blocking=True)
    for flag in (["--merge-lora"], ["--merge-lora", "--lora-rank", "4",
                                    "--lora-alpha", "8"]):
        with pytest.raises(StructureMismatch):
            serve.main(["--smoke", "--device", "cpu", "--ckpt",
                        str(tmp_path)] + flag)


def test_workload_is_the_reference_draws():
    from repro.launch.serve import build_workload as jax_workload
    for rate in (0.0, 5.0):
        got = serve.build_workload(12, 512, 64, 32, rate, seed=4)
        want = jax_workload(12, 512, 64, 32, rate, seed=4)
        assert [(r.prompt, r.max_gen, r.arrival) for r in got] == \
            [(r.prompt, r.max_gen, r.arrival) for r in want]


# ---------------------------------------------------------------------------
# Checkpoint -> serve
# ---------------------------------------------------------------------------

def _port_params(jparams):
    return interop.params_from_numpy(TCFG, flat_numpy(jparams), "cpu").tree()


def test_restore_params_reads_trailing_leaves(smoke, tmp_path):
    _, params = smoke
    opt = optim.make("adam", lr=1e-3)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"opt": opt.init(params), "params": params}, blocking=True)
    restored, step = cm.restore_params(None, lm.abstract_params(TCFG),
                                       device="cpu")
    assert step == 1
    for a, b in zip(flatten_with_paths(params)[1],
                    flatten_with_paths(restored)[1]):
        assert torch.equal(a, b)
    # a bare params tree (offset 0) loads through the same path
    cm2 = CheckpointManager(str(tmp_path / "bare"))
    cm2.save(2, params, blocking=True)
    restored2, _ = cm2.restore_params(None, lm.abstract_params(TCFG),
                                      device="cpu")
    for a, b in zip(flatten_with_paths(params)[1],
                    flatten_with_paths(restored2)[1]):
        assert torch.equal(a, b)
    # another arch -> a loud mismatch, not silently wrong weights
    wrong = TCFG.with_(d_model=64, head_dim=32, d_ff=128)
    with pytest.raises(StructureMismatch):
        cm.restore_params(None, lm.abstract_params(wrong), device="cpu")


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_train_checkpoint_serve_roundtrip(smoke, tmp_path, codec):
    """GWT-trained weights (f32 and int8 moments) restored by the engine
    give bitwise the direct forward's logits, and the engine's greedy
    tokens equal dense generate's."""
    jp, _ = smoke
    model = interop.params_from_numpy(TCFG, flat_numpy(jp), "cpu")
    params = model.tree()
    opt = optim.make("gwt", lr=1e-2, level=2, state_codec=codec)
    state = opt.init(params)
    data = SyntheticLM(TCFG.vocab, 16, 2, seed=5)
    step_fn = lm.make_train_step(TCFG, opt)
    for i in range(4):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, state, _ = step_fn(params, state, batch)
    cm = CheckpointManager(str(tmp_path))
    cm.save(4, {"opt": state, "params": params}, blocking=True)
    restored, _ = cm.restore_params(None, lm.abstract_params(TCFG),
                                    device="cpu")
    for a, b in zip(flatten_with_paths(params)[1],
                    flatten_with_paths(restored)[1]):
        assert torch.equal(a, b)
    tokens = torch.from_numpy(data.batch(9)["tokens"][:1, :12])
    with torch.no_grad():
        assert torch.equal(lm.forward(TCFG, params, tokens),
                           lm.forward(TCFG, restored, tokens))
    eng = Engine.from_checkpoint(TCFG, str(tmp_path),
                                 _ecfg(num_slots=2, max_ctx=24),
                                 device="cpu")
    req = Request(rid=0, prompt=tokens[0].tolist(), max_gen=5)
    eng.run([req])
    assert req.generated == _dense(restored, req.prompt, 5)


def test_lora_checkpoint_is_refused(smoke, tmp_path):
    """A checkpoint whose metadata names a LoRA fine-tune but which holds
    no adapters raises instead of serving its base weights as if merged;
    one without the fine-tune metadata serves.  (A real fine-tune's
    checkpoint is merged and served: tests/test_torch_lora.py.)"""
    cm = CheckpointManager(str(tmp_path), run_meta={
        "finetune": {"mode": "lora", "rank": 4, "alpha": 8.0}})
    cm.save(1, {"params": smoke[1]}, blocking=True)
    with pytest.raises(StructureMismatch):
        Engine.from_checkpoint(TCFG, str(tmp_path), _ecfg(), device="cpu")
    cm2 = CheckpointManager(str(tmp_path / "bare"))
    cm2.save(1, {"params": smoke[1]}, blocking=True)
    assert Engine.from_checkpoint(TCFG, str(tmp_path / "bare"), _ecfg(),
                                  device="cpu").kv_bytes() > 0


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def test_jax_checkpoint_serves_in_the_port(jax_trained):
    """A checkpoint the JAX package trained and saved: the port restores
    its params bitwise and serves the JAX engine's greedy tokens."""
    d, jparams, want = jax_trained
    eng = Engine.from_checkpoint(TCFG, d, _ecfg(), device="cpu")
    assert flatten_with_paths(eng.params)[0] == list(flat_numpy(jparams))
    for got, ref in zip(flatten_with_paths(eng.params)[1],
                        flat_numpy(jparams).values()):
        np.testing.assert_array_equal(got.numpy(), ref)
    reqs = _requests(6)
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    assert any(len(set(g)) > 1 for g in want)     # not one repeated token


def test_greedy_tokens_and_step_logits_match_jax_engine(jax_trained):
    """From the same trained params: the port's engine gives the JAX
    engine's greedy tokens, and the chunk-prefill and paged-decode steps'
    logits along one request (its prompt's positions, then each generated
    token) stay within TOL_STEP of the JAX steps'."""
    _, jparams, want = jax_trained
    params = _port_params(jparams)
    eng = Engine(TCFG, params, _ecfg())
    reqs = _requests(6)
    eng.run(reqs)
    assert [r.generated for r in reqs] == want
    r = max(reqs, key=lambda r: len(r.prompt) + len(r.generated))
    MP, P, C = 8, 4, 8
    pools = lm.init_paged_caches(TCFG, 1 + MP, P, device="cpu")
    jpools = jlm.init_paged_caches(JCFG, 1 + MP, P)
    pt = np.arange(1, MP + 1, dtype=np.int32)[None, :]
    chunk = lm.make_chunk_prefill_step(TCFG)
    jchunk = jax.jit(jlm.make_chunk_prefill_step(JCFG))
    for start in range(0, len(r.prompt), C):
        toks = np.zeros((1, C), np.int32)
        piece = r.prompt[start:start + C]
        toks[0, :len(piece)] = piece
        args = (pt, np.array([start], np.int32), toks)
        logits, _ = chunk(params, pools, *map(torch.from_numpy, args))
        jlogits, jpools = jchunk(jparams, jpools, *map(jnp.asarray, args))
        n = len(piece)
        assert spacings(logits[:, :n], jlogits[:, :n]) <= TOL_STEP
    decode = lm.make_paged_decode_step(TCFG)
    jdecode = jax.jit(jlm.make_paged_decode_step(JCFG))
    for i, tok in enumerate(r.generated[:-1]):
        args = (pt, np.array([len(r.prompt) + i], np.int32),
                np.array([[tok]], np.int32))
        logits, _ = decode(params, pools, *map(torch.from_numpy, args))
        jlogits, jpools = jdecode(jparams, jpools, *map(jnp.asarray, args))
        assert spacings(logits, jlogits) <= TOL_STEP, i
        assert int(torch.argmax(logits[0])) == r.generated[i + 1]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_kv_bytes_match_reference(smoke, quant):
    """The arena bytes equal the JAX engine's for the same EngineConfig,
    and at full width the numbers the card run checks."""
    ecfg = _ecfg(kv_quant=quant)
    jeng = jengine.Engine(JCFG, smoke[0],
                          jengine.EngineConfig(**ECFG, kv_quant=quant))
    assert Engine(TCFG, smoke[1], ecfg).kv_bytes() == jeng.kv_bytes()
    want = {("llama-60m", None): 25_427_968,
            ("llama-60m", "int8"): 13_508_608,
            ("qwen2.5-3b", None): 94_961_664,
            ("qwen2.5-3b", "int8"): 48_964_608}
    for arch, max_ctx in (("llama-60m", 192), ("qwen2.5-3b", 320)):
        e = EngineConfig(num_slots=8, page_size=16, max_ctx=max_ctx)
        n = e.resolved_num_pages()
        got = kv_lib.pool_bytes(lm.init_paged_caches(
            configs.get_config(arch), n, 16, quant, device="meta"))
        ref = jkv.pool_bytes(jlm.abstract_paged_caches(
            jconfigs.get_config(arch), n, 16, quant))
        assert got == ref == want[arch, quant]


def test_serve_engine_emits_request_records_at_retirement(smoke):
    sink = MemorySink()
    obs.configure(sink=sink, tracer=obs_trace.Tracer())
    try:
        eng = Engine(TCFG, smoke[1], EngineConfig(
            num_slots=2, page_size=8, max_ctx=16, prefill_chunk=8))
        rng = np.random.RandomState(5)
        reqs = [Request(rid=i, prompt=rng.randint(0, TCFG.vocab,
                                                  6).tolist(), max_gen=3)
                for i in range(3)]
        eng.run(reqs)
        tr = obs.get().tracer
    finally:
        obs.shutdown()
    recs = [r for r in sink.records if r["kind"] == "serve_request"]
    assert sorted(r["rid"] for r in recs) == [0, 1, 2]
    for r in recs:
        assert r["gen_tokens"] == 3 and r["prompt_tokens"] == 6
        assert 0.0 <= r["ttft_s"] <= r["latency_s"]
        assert r["done_s"] >= r["first_token_s"] >= r["admit_s"]
    kinds = [r["kind"] for r in sink.records]
    assert kinds.index("serve_run") > max(
        i for i, k in enumerate(kinds) if k == "serve_request")
    cats = {e.get("cat") for e in tr.events}
    names = {e.get("name") for e in tr.events}
    assert "serve" in cats and {"prefill", "decode", "sched"} <= names

"""The port's Haar DWT kernels' plain versions (K3 ``haar_dwt_fwd_q``, K6
``haar_dwt_fwd``, K7 ``haar_dwt_inv``) and its compressed data-parallel
reduction (``repro_torch.distributed.compression``) against the JAX
package, on the CPU.

Tolerances.  The port, the JAX package's eager ops and the CUDA kernels
round at every add and multiply.  Inside ``jit`` XLA's CPU backend
contracts ``a*s + b*s`` into a fused multiply-add (measured: the level-2
``A_l`` of ``ops.dwt_wire(impl="interpret")`` differs from the eager
``ref.haar_dwt_fwd_q`` in 757 of 3182 elements of a (37, 344) input).  So
the port is held bitwise to the reference's functions run op by op
(``jax.disable_jit()``: the oracles, ``emulated_mean(_ef)``), and to the
Pallas kernels in interpret mode bitwise at level 1 and, at levels 2-3,
within 4 f32 spacings (f32 bands) or one spacing of the band's dtype (bf16
and wire bands, which a last-place f32 difference can move across a
rounding boundary) at the band's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy

from repro.distributed import compression as jc
from repro.kernels.haar_dwt import ops as jops
from repro.kernels.haar_dwt import ref as jref
from repro_torch import configs
from repro_torch.distributed import compression as tc
from repro_torch.kernels.haar_dwt import kernel, ops, ref
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths

WIRES = ["bfloat16", "float16", "float8_e4m3fn"]


def _bits(a) -> np.ndarray:
    """The bit pattern of a JAX array or tensor, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        u = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            a.element_size()]
        a = a.view(u).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _bitwise(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    differ = int((g != w).sum())
    assert differ == 0, f"{what}: {differ} of {g.size} elements differ"


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


MANT_BITS = {"float32": 23, "bfloat16": 7, "float16": 10, "float8_e4m3fn": 3}


def _close_to_interpret(got, want, dtype: str, spacings: int):
    """``got`` within ``spacings`` units in the last place of ``dtype`` at
    the largest finite magnitude of rows 1.. (row 0 of the edge inputs
    holds 1e30 and +-inf), and with its non-finite values where ``want``
    has them."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    nonfin = ~np.isfinite(w)
    assert np.array_equal(nonfin, ~np.isfinite(g))
    np.testing.assert_array_equal(g[nonfin], w[nonfin])
    top = np.abs(w[1:][np.isfinite(w[1:])]).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - MANT_BITS[dtype])
    assert np.abs(g[1:] - w[1:]).max() <= spacings * ulp
    fin = ~nonfin[0]
    assert np.abs(g[0][fin] - w[0][fin]).max() <= \
        spacings * 2.0 ** (np.floor(np.log2(np.abs(w[0][fin]).max()))
                           - MANT_BITS[dtype])


def _edge_input(m=37, n=344, scale=100.0, seed=0):
    """f32 input whose detail bands reach past the fp8 range: values past
    464 and +-inf, each in its own level-3 group of 8 columns (no
    inf - inf)."""
    x = (np.random.RandomState(seed).randn(m, n) * scale).astype(np.float32)
    x[0, [0, 2, 4, 8, 16, 18, 20, 32]] = [464, 465, -465, 1e30, np.inf, 480,
                                         -1000, -np.inf]
    return x


def test_to_wire_matches_jax_casts():
    vals = np.array([0.0, -0.0, 2.0**-9, 2.0**-10, 448, 449, 463.99, 464,
                     464.01, 465, 480, 1000, 1e30, -464, -465, -1000,
                     np.inf, -np.inf, np.nan, -np.nan], np.float32)
    vals = np.concatenate([vals, (np.random.RandomState(1).randn(4096)
                                  * 300).astype(np.float32)])
    for name in WIRES:
        # NaN is part of the fp8 rule; in bf16 its payload differs (torch
        # writes 0xffff, JAX 0x7fc0 / 0xffc0) and is not compared
        x = vals if name == "float8_e4m3fn" else vals[~np.isnan(vals)]
        want = jnp.asarray(x).astype(jnp.dtype(name))
        got = ref.to_wire(torch.from_numpy(x), getattr(torch, name))
        _bitwise(got, want, name)
    # .to() alone saturates where the reference gives NaN
    sat = torch.tensor([465.0]).to(torch.float8_e4m3fn).view(torch.uint8)
    assert int(sat) == 0x7E
    assert int(ref.to_wire(torch.tensor([465.0]), torch.float8_e4m3fn)
               .view(torch.uint8)) == 0x7F


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_plain_k3_matches_reference(level, wire):
    """Bitwise to the oracle on details that cross the fp8 boundary
    (scale 300); to interpret mode on an input whose only non-finite
    details come from the edge values of row 0 (scale 1), so that no
    last-place difference moves a detail across 464."""
    tw, jw = getattr(torch, wire), jnp.dtype(wire)
    for scale in (300.0, 1.0):
        x = _edge_input(scale=scale, seed=level)
        got = ref.haar_dwt_fwd_q(torch.from_numpy(x), level, tw)
        jx = jnp.asarray(x)
        with jax.disable_jit():
            want = jref.haar_dwt_fwd_q(jx, level, jw)
        assert len(got) == len(want) == level + 1
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"band {i} vs ref")
        if level > 1 and scale != 1.0:
            continue
        interp = jops.dwt_wire(jx, level, jw, impl="interpret")
        for i, (g, p) in enumerate(zip(got, interp)):
            if level == 1:
                _bitwise(g, p, f"band {i} vs interpret")
            elif i == 0:
                _close_to_interpret(g, p, "float32", 4)
            else:
                _close_to_interpret(g, p, wire, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_plain_k6_k7_match_reference(level, dtype):
    x = np.random.RandomState(level).randn(24, 344).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ref.haar_dwt_fwd(tx, level)
    interp = jops.dwt(jx, level, impl="interpret")
    for i, (g, p) in enumerate(zip(got, interp)):
        assert g.dtype == tx.dtype
        if dtype == "float32":
            with jax.disable_jit():
                _bitwise(g, jref.haar_dwt_fwd(jx, level)[i], f"band {i}")
        if level == 1:
            _bitwise(g, p, f"band {i} vs interpret")
        else:
            _close_to_interpret(g, p, dtype, 4 if dtype == "float32" else 1)
    # the inverse, of the bands the reference's forward gives
    bands = [jnp.asarray(to_numpy(b)).astype(jx.dtype) for b in interp]
    tb = [torch.from_numpy(to_numpy(b).copy()).to(tx.dtype) for b in interp]
    inv = ref.haar_dwt_inv(tb[0], tb[1:])
    assert inv.dtype == tx.dtype and tuple(inv.shape) == x.shape
    _bitwise(inv, jops.idwt(bands[0], bands[1:], impl="interpret"),
             "inverse vs interpret")
    if dtype == "float32":
        with jax.disable_jit():
            _bitwise(inv, jref.haar_dwt_inv(bands[0], bands[1:]),
                     "inverse vs ref")


def test_cpu_tensors_take_the_plain_versions():
    before = (kernel.launches_fwd, kernel.launches_fwd_q,
              kernel.launches_inv)
    x = torch.randn(8, 64)
    a, *ds = ops.dwt_wire(x, 2, torch.bfloat16)
    assert a.dtype == torch.float32 and ds[0].dtype == torch.bfloat16
    torch.testing.assert_close(ops.idwt(*ops.dwt(x, 2)[:1],
                                        list(ops.dwt(x, 2)[1:])), x)
    assert (kernel.launches_fwd, kernel.launches_fwd_q,
            kernel.launches_inv) == before


@pytest.mark.parametrize("wire", WIRES + [None])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_emulated_means_match_reference(D, wire):
    rng = np.random.RandomState(D)
    g = rng.randn(D, 8, 64).astype(np.float32)
    err = (rng.randn(D, 8, 64) * 1e-3).astype(np.float32)
    jw = None if wire is None else jnp.dtype(wire)
    tw = None if wire is None else getattr(torch, wire)
    with jax.disable_jit():
        want = jc.emulated_mean(jnp.asarray(g), 2, jw)
        want_ef, want_err = jc.emulated_mean_ef(jnp.asarray(g),
                                                jnp.asarray(err), 2, jw)
    _bitwise(tc.emulated_mean(torch.from_numpy(g), 2, tw), want, "mean")
    got_ef, got_err = tc.emulated_mean_ef(torch.from_numpy(g),
                                          torch.from_numpy(err), 2, tw)
    _bitwise(got_ef, want_ef, "mean_ef")
    _bitwise(got_err, want_err, "residues")


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("D", [1, 2, 3])
def test_reduce_terms_and_reconstruct_match_reference(D, wire):
    """Per-rank wire terms of a stacked (D, 4, 8, 64) gradient, their
    reconstruction after a sum over D ranks, and the local residue."""
    g = np.random.RandomState(10 + D).randn(D, 4, 8, 64).astype(np.float32)
    with jax.disable_jit():
        ja, jds = jc.reduce_terms(jnp.asarray(g), 2, jnp.dtype(wire))
        jrec = jc.reconstruct(ja, jds, D)
        jres = jc.local_residual(jnp.asarray(g), ja, jds)
    ta, tds = tc.reduce_terms(torch.from_numpy(g), 2, getattr(torch, wire))
    _bitwise(ta, ja, "A_l")
    for t, j in zip(tds, jds):
        _bitwise(t, j, "detail")
    _bitwise(tc.reconstruct(ta, tds, D), jrec, "reconstruct")
    _bitwise(tc.local_residual(torch.from_numpy(g), ta, tds), jres,
             "residue")


def test_non_compressible_leaves_take_the_exact_mean():
    g = torch.randn(3, 6)   # 6 % 4 != 0
    for fn in (lambda: tc.compressed_mean(g, None),
               lambda: tc.compressed_mean_ef(g, torch.ones(3, 6), None)[0]):
        torch.testing.assert_close(fn(), g, rtol=0, atol=0)
    assert torch.equal(tc.compressed_mean_ef(g, torch.ones(3, 6), None)[1],
                       torch.zeros(3, 6))
    for shape, level, want in [((4, 8), 2, True), ((8,), 2, False),
                               ((4, 6), 2, False), ((4, 6), 1, True),
                               ((4, 8), 0, False)]:
        assert tc.compressible(shape, level) == jc.compressible(shape,
                                                                level) == want


def test_tree_wire_bytes_match_reference_at_llama_60m():
    params = lm.abstract_params(configs.get_config("llama-60m"))
    exact = tc.tree_wire_bytes(params, None)
    bf16 = tc.tree_wire_bytes(params, tc.DPReduceSpec.parse("compressed"))
    fp8 = tc.tree_wire_bytes(params, tc.DPReduceSpec.parse(
        "compressed", detail_dtype="float8_e4m3fn"))
    assert (exact, bf16, fp8) == (333_516_800, 208_449_536, 145_915_904)
    assert tc.tree_wire_bytes(params, tc.DPReduceSpec.parse("exact")) \
        == exact
    abstract = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.bfloat16)
                for k, v in zip(*flatten_with_paths(params))}
    assert jc.tree_wire_bytes(abstract, jc.DPReduceSpec.parse(
        "compressed", detail_dtype="float8_e4m3fn")) == fp8


def test_spec_parse_matches_reference():
    for args in [("none",), ("exact",), ("compressed",),
                 ("compressed", 3, "float16", True)]:
        j, t = jc.DPReduceSpec.parse(*args), tc.DPReduceSpec.parse(*args)
        if j is None:
            assert t is None
            continue
        assert (t.level, t.exact, t.error_feedback) == \
            (j.level, j.exact, j.error_feedback)
        assert (t.detail_dtype is None) == (j.detail_dtype is None)
    for bad in [("none", 2, "bfloat16", True), ("exact", 2, "bfloat16", True),
                ("ring",)]:
        with pytest.raises(ValueError) as te:
            tc.DPReduceSpec.parse(*bad)
        with pytest.raises(ValueError) as je:
            jc.DPReduceSpec.parse(*bad)
        assert str(te.value) == str(je.value)


def test_launcher_rejects_what_it_does_not_run(capsys):
    base = ["--smoke", "--steps", "1", "--device", "cpu"]
    for argv, msg in [(["--mesh", "1x1", "--dp-reduce", "exact"],
                       "needs a pure-DP mesh"),
                      (["--dp-error-feedback"], "needs --dp-reduce"),
                      (["--dp-reduce", "exact", "--dp-error-feedback"],
                       "meaningless")]:
        with pytest.raises(SystemExit):
            train.main(base + argv)
        assert msg in capsys.readouterr().err


def test_launcher_dp_path_on_one_rank(capsys):
    before = kernel.launches_fwd_q
    res = train.main(["--smoke", "--steps", "4", "--batch", "4", "--seq",
                      "32", "--log-every", "2", "--device", "cpu",
                      "--dp-reduce", "compressed", "--dp-detail-dtype",
                      "float8_e4m3fn", "--dp-error-feedback"])
    out = capsys.readouterr().out
    assert "dp_reduce=compressed dp=1 wire=0.1MiB/step vs exact 0.2MiB " \
        "(2.28x)" in out
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    assert set(res.opt_state) == {"opt", "dp_ef"}
    assert int(res.opt_state["opt"]["step"]) == 4
    ef = res.opt_state["dp_ef"]["layers"]["b0"]["mixer"]["wq"]
    assert ef.shape[0] == 1 and float(ef.abs().max()) > 0
    assert float(res.opt_state["dp_ef"]["final_norm"].abs().max()) == 0
    assert kernel.launches_fwd_q == before

"""The port's state codec (``repro_torch.optim.codec``) against the JAX
package's ``repro.optim.codec`` on inputs made from numpy seeds.

Everything here is integer arithmetic or exact float steps, so the hash,
the salts, the uniforms, the codes and the scales must agree bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads)

from repro.optim import codec as jcodec
from repro_torch.optim import codec


def _u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, 2**32 - 1])
def test_make_key_is_bitwise(seed):
    got = codec.make_key(seed)
    assert got.dtype == torch.uint32 and got.shape == ()
    assert int(got) == int(jcodec.make_key(seed))


@pytest.mark.parametrize("step", [0, 1, 977, 2**31 - 2, 2**31 - 1])
@pytest.mark.parametrize("slot", [0, 1])
def test_slot_salt_is_bitwise(step, slot):
    key, jkey = codec.make_key(7), jcodec.make_key(7)
    ids = np.arange(0, 40, 3, dtype=np.int32)
    want = jcodec.slot_salt(jkey, jnp.int32(step), slot, jnp.asarray(ids))
    got = codec.slot_salt(key, torch.tensor(step, dtype=torch.int32), slot,
                          torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), _u32(want))
    # a scalar leaf id, and a plain int step
    want1 = jcodec.slot_salt(jkey, step, slot, 5)
    assert int(codec.slot_salt(key, step, slot, 5)) == int(_u32(want1))


def test_salt_table_is_bitwise():
    """The engine's per-step table: one broadcast call over (slot, leaf)
    equals the JAX package's salts slot by slot."""
    key, jkey = codec.make_key(3), jcodec.make_key(3)
    ids = np.arange(11, dtype=np.int32)
    got = codec.slot_salt(key, torch.tensor(6, dtype=torch.int32),
                          torch.arange(2)[:, None], torch.from_numpy(ids))
    assert got.shape == (2, 11)
    for slot in (0, 1):
        want = jcodec.slot_salt(jkey, jnp.int32(6), slot, jnp.asarray(ids))
        np.testing.assert_array_equal(got[slot].numpy(), _u32(want))


def test_uniform01_is_bitwise():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 2**31 - 1, size=4096).astype(np.int64)
    idx[:4] = [0, 1, 2**31 - 1, 2**32 - 1]
    for salt in (0, 0xDEADBEEF, 2**32 - 1):
        want = jcodec.uniform01(jnp.uint32(salt),
                                jnp.asarray(idx.astype(np.uint32)))
        got = codec.uniform01(torch.tensor(salt), torch.from_numpy(idx))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# shapes ending in a partial block (size not a multiple of 64) and not
@pytest.mark.parametrize("shape", [(64,), (3, 100), (5, 7, 9), (2, 128),
                                   (1,)])
@pytest.mark.parametrize("rounding", ["stochastic", "nearest"])
def test_blocked_quant_and_dequant_are_bitwise(shape, rounding):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32)
    x.reshape(-1)[:min(x.size, 3)] = 0.0
    salt = codec.slot_salt(codec.make_key(1), 9, 1, 4)
    jsalt = jcodec.slot_salt(jcodec.make_key(1), 9, 1, 4)
    jq, js = jcodec.blocked_quant(jnp.asarray(x), jsalt, rounding=rounding)
    q, s = codec.blocked_quant(torch.from_numpy(x), salt, rounding=rounding)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.shape == (codec.num_blocks(x.size),)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        codec.blocked_dequant(q, s).numpy(),
        np.asarray(jcodec.blocked_dequant(jq, js)))


def test_codes_of_a_partial_last_block_are_contiguous():
    """Stored codes are updated in place by the CUDA kernel, so rows that
    end in a partial block must not come back as a strided slice."""
    q, s = codec.quant_blocks(torch.randn(3, 100), torch.arange(3))
    assert q.shape == (3, 100) and q.is_contiguous()
    assert s.shape == (3, 2)


def test_all_zero_block_encodes_exactly():
    q, s = codec.blocked_quant(torch.zeros(130), 5)
    assert not q.any() and not s.any()
    assert not codec.blocked_dequant(q, s).any()


def test_codec_encode_decode_match_reference():
    x = np.random.RandomState(4).randn(6, 50).astype(np.float32)
    c, jc = codec.get_codec("int8"), jcodec.get_codec("int8")
    enc, jenc = c.encode(torch.from_numpy(x), 77), jc.encode(jnp.asarray(x),
                                                             jnp.uint32(77))
    for k in ("q", "scale"):
        np.testing.assert_array_equal(enc[k].numpy(), np.asarray(jenc[k]))
    init = c.init(torch.empty((6, 50), device="meta"))
    assert init["q"].dtype == torch.int8 and init["scale"].shape == (5,)
    assert codec.get_codec("f32").passthrough
    with pytest.raises(ValueError, match="unknown state codec"):
        codec.get_codec("int4")


def test_map_slots_order_matches_reference():
    mask = {"host": {"v": True, "m": True, "z": False}, "prev_norm": False}
    state = {"host": {"m": 1, "v": 2, "z": 3}, "prev_norm": 4}
    seen, jseen = [], []
    codec.map_slots(mask, state, lambda i, s: seen.append((i, s)) or s)
    jcodec.map_slots(mask, state, lambda i, s: jseen.append((i, s)) or s)
    assert seen == jseen == [(0, 1), (1, 2)]

"""Parity of the port's wire codec (gaussiank_sgd_torch/parallel/wire.py) and
``pack_wire_words`` with the reference's, bit for bit.

One test for each codec and gate case of ``tests/test_wire.py``, run on the
same inputs through both packages; the port's int32 words are compared
with the reference's uint32 words by their bits. The f32 -> bf16 rounding
is held to XLA's on special values too: NaN payloads (XLA makes the quiet
NaN with its sign, torch's own conversion does not), ±inf, ±0.0, the
overflow to inf and subnormals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiank_sgd_tpu.compressors import CompressedGrad as JComp
from gaussiank_sgd_tpu.ops.pallas_pack import pack_wire_words as jpack
from gaussiank_sgd_tpu.parallel import wire as jwire
from gaussiank_sgd_tpu.parallel.bucketing import make_bucket_plan as jplan
from gaussiank_sgd_torch.compressors import CompressedGrad
from gaussiank_sgd_torch.ops.fused_select import pack_wire_words
from gaussiank_sgd_torch.parallel import wire
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype.itemsize == 4 else x


def _same(port, ref):
    np.testing.assert_array_equal(_bits(port), _bits(ref))


def _words_roundtrip(rel, val):
    words = wire.encode_entries(_t(rel), _t(val))
    jwords = jwire.encode_entries(jnp.asarray(rel), jnp.asarray(val))
    assert words.dtype == torch.int32 and jwords.dtype == jnp.uint32
    _same(words, jwords)
    r2, v2 = wire.decode_entries(words)
    jr2, jv2 = jwire.decode_entries(jwords)
    _same(r2, jr2)
    _same(v2, jv2)
    return r2.numpy(), v2.numpy()


def test_entry_roundtrip_rel_boundaries():
    """rel 0 and 65,535 (the u16 extremes; rel >= 32768 sets the int32
    sign bit) and the values, bit for bit with the reference."""
    rel = np.array([0, 1, 255, 256, 32767, 32768, 65534, 65535], np.int32)
    val = np.array([1.0, -2.0, 0.5, -0.25, 3.0, -3.0, 3.0, -4.0], np.float32)
    r2, v2 = _words_roundtrip(rel, val)
    np.testing.assert_array_equal(r2, rel)
    np.testing.assert_array_equal(v2, val)


def test_entry_value_error_at_most_one_ulp():
    vals = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096,),
                                        jnp.float32)
                      * jnp.logspace(-20, 20, 4096, dtype=jnp.float32))
    _, back = _words_roundtrip(np.zeros(4096, np.int32), vals)
    assert np.all(np.abs(back - vals) <= np.abs(vals) * 2.0 ** -8 + 1e-38)
    _same(wire.bf16_roundtrip(_t(vals)), jwire.bf16_roundtrip(
        jnp.asarray(vals)))


SPECIAL = np.array([
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000,       # ±0, ±inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA12345,       # NaNs
    0xFFB00001, 0x7FFFFFFF, 0xFFFFFFFF,
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,                   # overflow to inf
    0x00000001, 0x80000001, 0x00008000, 0x00018000,       # subnormals
    0x0000FFFF, 0x007FFFFF, 0x807FFFFF,
    0x3F808000, 0x3F818000, 0x3F80C000, 0x3F807FFF,       # ties and halves
], np.uint32).view(np.float32)


def test_entry_special_values():
    """Zero keeps its sign, the dynamic-range ends stay finite, and every
    special pattern quantizes to the reference's bf16 bits."""
    val = np.array([0.0, -0.0, 1e-38, -1e38, 3.389e38], np.float32)
    _, got = _words_roundtrip(np.zeros(5, np.int32), val)
    assert np.signbit(got[1]) and not np.signbit(got[0])
    assert np.all(np.isfinite(got))
    _words_roundtrip(np.zeros(SPECIAL.size, np.int32), SPECIAL)
    q = wire.quantize_values(_t(SPECIAL))
    jq = jwire.quantize_values(jnp.asarray(SPECIAL))
    np.testing.assert_array_equal(
        q.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jax.lax.bitcast_convert_type(jq, jnp.uint16)))
    _same(wire.dequantize_values(q), jwire.dequantize_values(jq))
    _same(wire.bf16_roundtrip(_t(SPECIAL)),
          jwire.bf16_roundtrip(jnp.asarray(SPECIAL)))


def _grouped_comp(n_buckets, chunk, slots, seed=0):
    """Bucket-major pairs with each bucket's rel extremes (0, chunk - 1)
    and random fill on the 1/8 grid (bf16-exact at these magnitudes)."""
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, chunk, size=(n_buckets, slots)).astype(np.int32)
    rel[:, 0], rel[:, 1] = 0, chunk - 1
    base = (np.arange(n_buckets, dtype=np.int32) * chunk)[:, None]
    val = (np.round(rng.normal(size=n_buckets * slots) * 8) / 8)
    return (base + rel).reshape(-1), val.astype(np.float32)


def _formats(sizes, density, **kw):
    plan = make_bucket_plan(sizes, density, **kw)
    jp = jplan(sizes, density, **kw)
    assert plan == jp
    wf, jwf = (wire.plan_wire_format(plan, torch.float32),
               jwire.plan_wire_format(jp, jnp.float32))
    assert (wf is None) == (jwf is None)
    if wf is not None:
        assert tuple(wf) == tuple(jwf)
    return wf, jwf


def test_grouped_roundtrip_at_bucket_boundaries():
    wf, jwf = _formats([200_000], 0.001, bucket_size=65_536,
                       policy="uniform")
    assert wf.chunk == 65_536 and wf.n_buckets == 4
    idx, val = _grouped_comp(wf.n_buckets, wf.chunk, 66)
    words = wire.encode_grouped(CompressedGrad(_t(idx), _t(val)), wf)
    jwords = jwire.encode_grouped(JComp(jnp.asarray(idx),
                                        jnp.asarray(val)), jwf)
    _same(words, jwords)
    back = wire.decode_grouped(words, wf, idx.size)
    jback = jwire.decode_grouped(jwords, jwf, idx.size)
    _same(back.indices, jback.indices)
    _same(back.values, jback.values)
    np.testing.assert_array_equal(back.indices.numpy(), idx)
    np.testing.assert_array_equal(back.values.numpy(), val)


def test_grouped_decode_multiworker_payload():
    """Three workers' payloads, tiled as the all-gather tiles them: each
    entry's bucket comes from its position within its own payload."""
    wf, jwf = _formats([1024], 0.01, bucket_size=256, policy="uniform")
    comps = [_grouped_comp(wf.n_buckets, wf.chunk, 4, seed=s)
             for s in range(3)]
    gathered = torch.cat([wire.encode_grouped(
        CompressedGrad(_t(i), _t(v)), wf) for i, v in comps])
    jgathered = jnp.concatenate([jwire.encode_grouped(
        JComp(jnp.asarray(i), jnp.asarray(v)), jwf) for i, v in comps])
    _same(gathered, jgathered)
    back = wire.decode_grouped(gathered, wf, comps[0][0].size)
    jback = jwire.decode_grouped(jgathered, jwf, comps[0][0].size)
    _same(back.indices, jback.indices)
    _same(back.values, jback.values)
    np.testing.assert_array_equal(back.indices.numpy(),
                                  np.concatenate([i for i, _ in comps]))


def test_grouped_rejects_ragged_payload():
    wf, _ = _formats([512], 0.01, bucket_size=256, policy="uniform")
    with pytest.raises(ValueError):
        wire.encode_grouped(CompressedGrad(
            torch.zeros(5, dtype=torch.int32), torch.zeros(5)), wf)
    with pytest.raises(ValueError):
        wire.decode_grouped(torch.zeros(5, dtype=torch.int32), wf, 4)


def test_sorted_roundtrip():
    wf, jwf = _formats([1000], 0.05, bucket_size=300, policy="uniform")
    assert wf.n_buckets == 4
    idx = np.array([999, 0, 299, 300, 601, 42, 300], np.int32)
    val = np.array([1.0, -2.0, 0.5, 4.0, -0.125, 8.0, 3.0], np.float32)
    words, counts = wire.encode_sorted(_t(idx), _t(val), wf)
    jwords, jcounts = jwire.encode_sorted(jnp.asarray(idx),
                                          jnp.asarray(val), jwf)
    _same(words, jwords)                 # the duplicate 300 keeps its order
    _same(counts, jcounts)
    i2, v2 = wire.decode_sorted(words, counts, wf)
    ji2, jv2 = jwire.decode_sorted(jwords, jcounts, jwf)
    _same(i2, ji2)
    _same(v2, jv2)
    assert np.all(np.diff(i2.numpy()) >= 0)


@pytest.mark.parametrize("case", [
    "exactly_65536", "oversized_chunk", "non_f32_grads", "non_uniform_plan",
    "single_greedy_bucket"])
def test_gate_matches_reference(case):
    """The five gate cases of the reference's tests."""
    if case == "exactly_65536":
        wf, _ = _formats([200_000], 0.001, bucket_size=65_536,
                         policy="uniform")
        assert wf is not None and wf.name == wire.WIRE_PACKED
    elif case == "oversized_chunk":
        wf, _ = _formats([200_000], 0.001, bucket_size=131_072,
                         policy="uniform")
        assert wf is None
    elif case == "non_f32_grads":
        plan = make_bucket_plan([4096], 0.01, bucket_size=1024,
                                policy="uniform")
        jp = jplan([4096], 0.01, bucket_size=1024, policy="uniform")
        assert wire.plan_wire_format(plan, torch.bfloat16) is None
        assert jwire.plan_wire_format(jp, jnp.bfloat16) is None
        assert wire.plan_wire_format(plan, torch.float32) is not None
    elif case == "non_uniform_plan":
        wf, _ = _formats([700, 300], 0.01, bucket_size=0)
        assert wf is None
    else:
        wf, _ = _formats([676], 0.1)
        assert wf.n_buckets == 1 and wf.chunk == 676


def test_pack_wire_words_matches_reference():
    """The fused path's chunk-local ``[n_chunks, k]`` selection straight to
    words, with rel at both u16 ends and padding slots (0, 0.0)."""
    rng = np.random.default_rng(3)
    idx2d = rng.integers(0, 65_536, size=(4, 66)).astype(np.int32)
    idx2d[:, 0], idx2d[:, 1], idx2d[:, -3:] = 65_535, 32_768, 0
    val2d = rng.normal(size=(4, 66)).astype(np.float32)
    val2d[:, -3:] = 0.0
    words = pack_wire_words(_t(idx2d), _t(val2d))
    assert words.shape == (4, 66) and words.dtype == torch.int32
    _same(words, jpack(jnp.asarray(idx2d), jnp.asarray(val2d)))

"""repro_torch.core.compression against repro.core.compression: the
fused flat-buffer wire (layout, bytes, params, CRC) is the JAX
package's, each package decodes the other's messages, and the CRC and
finite guards refuse corrupt ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch import interop
from repro_torch.core import compression as tcomp
from repro_torch.core import prng, pytree


def _tree(seed=0, n1=777, n2=95):
    """Nested dict whose insertion order differs from its sorted order,
    odd sizes, a list of blocks."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa
    return {"wq": f(n1), "attn": {"z": f(n2, 3), "a": f(5, 7)},
            "blocks": [{"w": f(33), "b": f(2, 2, 2)}, {"w": f(1)}],
            "b": f(4099)}


def _torch_tree(tree):
    """numpy tree -> tensors, keeping each dict's insertion order."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _both(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), _torch_tree(tree)


def _u32(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_leaf_order_is_jax_sorted_order():
    """Fault 3: JAX flattens dict keys sorted; the port's layout must not
    follow insertion order."""
    jt, tt = _both(_tree())
    jl = jcomp.FlatLayout.from_tree(jt)
    tl = tcomp.FlatLayout.from_tree(tt)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.shapes == jl.shapes and tl.total == jl.total
    for a, b in zip(jax.tree_util.tree_leaves(jt), pytree.tree_leaves(tt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert list(tt) == ["wq", "attn", "blocks", "b"]      # insertion order


def test_layout_round_trip_and_cache():
    _, tt = _both(_tree(1))
    layout = tcomp.FlatLayout.from_tree(tt)
    assert layout is tcomp.FlatLayout.from_tree(tt)
    flat = layout.flatten(tt)
    back = layout.unflatten(flat)
    for a, b in zip(pytree.tree_leaves(tt), pytree.tree_leaves(back)):
        assert a.shape == b.shape and torch.equal(a, b)
    padded = layout.flatten(tt, padded_len=layout.total + 10)
    assert torch.equal(padded[:layout.total], flat)
    assert bool((padded[layout.total:] == flat[-1]).all())
    bf = {"x": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    bl = tcomp.FlatLayout.from_tree(bf)
    assert bl.unflatten(bl.flatten(bf))["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["rq8", "rq4", "rq2"])
@pytest.mark.parametrize("bucket_elems", [2048, 1 << 22])
def test_tree_encode_flat_bytes_params_crc_equal_jax(name, bucket_elems):
    jt, tt = _both(_tree(2))
    jp = jcomp.codec(name).tree_encode_flat(jt, jax.random.PRNGKey(9),
                                            bucket_elems=bucket_elems)
    tp = tcomp.codec(name).tree_encode_flat(tt, prng.PRNGKey(9),
                                            bucket_elems=bucket_elems)
    np.testing.assert_array_equal(tp.payload.numpy(), np.asarray(jp.payload))
    np.testing.assert_array_equal(_u32(tp.params.numpy()), _u32(jp.params))
    assert tp.wire_bytes == jp.wire_bytes
    assert tcomp.codec(name).tree_wire_bytes_flat(
        tt, bucket_elems=bucket_elems) == jcomp.codec(
            name).tree_wire_bytes_flat(jt, bucket_elems=bucket_elems)
    assert tcomp.wire_crc32(tp) == jcomp.wire_crc32(jp)
    assert tcomp.wire_bits(tp) == jcomp.wire_bits(jp)
    # flat_encode of the flattened buffer is the same message
    layout = tcomp.FlatLayout.from_tree(tt)
    fp = tcomp.codec(name).flat_encode(layout.flatten(tt), prng.PRNGKey(9),
                                       layout, bucket_elems=bucket_elems)
    assert torch.equal(fp.payload, tp.payload)
    assert torch.equal(fp.params, tp.params)


@pytest.mark.parametrize("name", ["rq8", "rq4", "rq2"])
def test_jax_wire_decodes_in_the_port_bitwise(name):
    jt, tt = _both(_tree(3))
    jp = jcomp.codec(name).tree_encode_flat(jt, jax.random.PRNGKey(1),
                                            bucket_elems=4096)
    want = jcomp.codec(name).tree_decode_flat(jp)
    wire = interop.wire_from_jax(jp.payload, jp.params, tree=tt, codec=name,
                                 bucket_elems=4096)
    got = tcomp.codec(name).tree_decode_flat(wire)
    for a, b in zip(jax.tree_util.tree_leaves(want), pytree.tree_leaves(got)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(_u32(b.numpy()), _u32(a))
    # and the port's wire decodes in JAX to the same values
    tp = tcomp.codec(name).tree_encode_flat(tt, prng.PRNGKey(1),
                                            bucket_elems=4096)
    back = jcomp.codec(name).tree_decode_flat(jcomp.FlatPacked(
        jnp.asarray(tp.payload.numpy()), jnp.asarray(tp.params.numpy()),
        jcomp.FlatLayout.from_tree(jt), name, 4096))
    for a, b in zip(jax.tree_util.tree_leaves(back), pytree.tree_leaves(got)):
        np.testing.assert_array_equal(_u32(b.numpy()), _u32(a))


@pytest.mark.parametrize("bit", [0, 77, 8 * 3000 + 5, -1])
def test_flip_bit_is_caught_by_the_crc(bit):
    _, tt = _both(_tree(4))
    packed, crc = tcomp.frame(tcomp.codec("rq8").tree_encode_flat(
        tt, prng.PRNGKey(0)))
    tcomp.verify_wire(packed, crc)
    bit = bit % tcomp.wire_bits(packed)
    bad = tcomp.flip_bit(packed, bit)
    with pytest.raises(tcomp.WireCorruptionError, match="CRC32 mismatch"):
        tcomp.verify_wire(bad, crc)
    diff = (np.unpackbits(bad.payload.numpy()) != np.unpackbits(
        packed.payload.numpy())).sum() + (np.unpackbits(
            bad.params.numpy().view(np.uint8)) != np.unpackbits(
                packed.params.numpy().view(np.uint8))).sum()
    assert diff == 1
    with pytest.raises(ValueError, match="outside"):
        tcomp.flip_bit(packed, tcomp.wire_bits(packed))


def test_guard_finite_refuses_nan():
    _, tt = _both(_tree(5))
    tcomp.guard_finite(tt)
    tt["attn"]["a"][0, 0] = float("nan")
    with pytest.raises(tcomp.WireCorruptionError, match="NaN"):
        tcomp.guard_finite(tt)


def test_codec_registry():
    """The port registers every codec of the JAX package, with the same
    specs; an unknown name lists them."""
    assert sorted(tcomp.CODECS) == sorted(jcomp.CODECS)
    assert tcomp.codec("rq4").bits == 4
    for name in jcomp.CODECS:
        assert dataclasses.astuple(tcomp.codec(name).spec) == \
            dataclasses.astuple(jcomp.codec(name).spec)
        assert tcomp.codec(name).packable == jcomp.codec(name).packable
    with pytest.raises(KeyError, match="unknown compression 'gzip'"):
        tcomp.codec("gzip")

"""The partitioned ring AllReduce of repro_torch against repro's.

The literal port of the TPU kernel (``ref.decode_add_encode_bucketed``,
fed uniforms) and K5's keyed plain version (what
``kernel.decode_add_encode_bucketed`` runs on CPU tensors: its own draws
from the buckets' keys) equal the JAX package's ``_dae_ref`` and its
Pallas kernel in interpret mode, fed ``jax.random.uniform`` under the
same keys, bit for bit; the N-worker hop equals N one-worker hops; the
flat hop, the partition geometry and
the partitioned wire objects are JAX's; and ``CSGDRingExchange`` on
stacked gradients gives the bits of JAX's vmapped exchange for the
partitioned and the monolithic chains. Inputs are numpy arrays from a
seed, handed to both packages. The CUDA kernel itself is held against
the same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import communicators as JC
from repro.core import compression as jcomp
from repro.kernels.quant import kernel as jkernel
from repro.kernels.quant import ops as jops
from repro_torch import interop
from repro_torch.core import communicators as TC
from repro_torch.core import compression as tcomp
from repro_torch.core import prng, pytree
from repro_torch.kernels.quant import kernel, ops, ref

AXIS = "workers"


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _incoming(total, bits, be, seed):
    """A JAX-encoded incoming message of ``total`` elements and a local
    addend, both from a seed."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=total) * 0.05).astype(np.float32)
    loc = (rng.normal(size=total) * 0.05).astype(np.float32)
    pay, par = jops.encode_flat(jnp.asarray(x), jax.random.PRNGKey(seed),
                                bits=bits, bucket_elems=be, backend="jnp")
    return np.array(pay), np.array(par), loc


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("b,rows", [(3, 4), (1, 5)])
def test_dae_plain_equals_jax_ref_and_pallas_interpret(bits, b, rows):
    """The TPU kernel's literal port == JAX's jitted _dae_ref == the
    Pallas kernel in interpret mode, bit for bit: a multi-bucket head and
    a B = 1 tail, given the same payload, params, addend and uniforms."""
    pack = 8 // bits
    pay, par, _ = _incoming(b * pack * rows * 512, bits, pack * rows * 512,
                            seed=bits + b)
    pay = pay.reshape(b, rows, 512)
    rng = np.random.default_rng(b * bits)
    x4 = (rng.normal(size=(b, pack, rows, 512)) * 0.05).astype(np.float32)
    u4 = rng.random(size=x4.shape).astype(np.float32)
    want, want_p = jax.jit(jops._dae_ref, static_argnames="bits")(
        pay, par, x4, u4, bits=bits)
    pal, pal_p = jkernel.decode_add_encode_bucketed(
        jnp.asarray(pay), jnp.asarray(par), jnp.asarray(x4),
        jnp.asarray(u4), bits=bits, block_r=8, interpret=True)
    got, got_p = ref.decode_add_encode_bucketed(
        torch.from_numpy(pay), torch.from_numpy(par), torch.from_numpy(x4),
        torch.from_numpy(u4), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_u32(got_p.numpy()), _u32(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    np.testing.assert_array_equal(_u32(got_p.numpy()), _u32(pal_p))


@pytest.mark.parametrize("total,be,bits", [
    (3 * 4096, 4096, 8), (5 * 4096 + 2048, 4096, 4),
    (5 * 4096 + 2048, 4096, 2), (4096, 1 << 22, 4), (4099, 4096, 8),
    (4099, 4096, 2)])
def test_decode_add_encode_flat_equals_jax_and_composition(total, be, bits):
    """ops.decode_add_encode_flat == JAX's (jnp backend) on aligned
    multi-bucket, short-last-bucket, single-bucket and unaligned totals,
    and == the port's encode_flat(decode_flat(.) + local)."""
    pay, par, loc = _incoming(total, bits, be, seed=total + bits)
    want, want_p = jops.decode_add_encode_flat(
        jnp.asarray(pay), jnp.asarray(par), jnp.asarray(loc),
        jax.random.PRNGKey(7), bits=bits, bucket_elems=be, backend="jnp")
    tpay, tpar = torch.from_numpy(pay), torch.from_numpy(par)
    got, got_p = ops.decode_add_encode_flat(tpay, tpar, torch.from_numpy(loc),
                                            prng.PRNGKey(7), bits=bits,
                                            bucket_elems=be)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_u32(got_p.numpy()), _u32(want_p))
    dec = ops.decode_flat(tpay, tpar, total=total, bits=bits,
                          bucket_elems=be)
    via, via_p = ops.encode_flat(dec + torch.from_numpy(loc), prng.PRNGKey(7),
                                 bits=bits, bucket_elems=be)
    assert torch.equal(got, via) and torch.equal(got_p.view(torch.int32),
                                                 via_p.view(torch.int32))


def _mixed_tree(seed=0, n1=5000, n2=300):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa
    return {"a": f(n1), "b": {"w": f(n2, 3), "s": f(1)}, "c": [f(7, 5)]}


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_partition_geometry_and_partitioned_wire_equal_jax(bits):
    """partition_geometry, tree_encode_partitioned's bytes and params,
    flat_decode_partitioned and the wire byte counts equal JAX's."""
    for total in (1, 77, 4096, 100_003, 128_994_048):
        for n in (1, 2, 3, 4, 8):
            for be in (2048, 1 << 22):
                assert ops.partition_geometry(
                    total, n, bits=bits, bucket_elems=be) == \
                    jops.partition_geometry(total, n, bits=bits,
                                            bucket_elems=be)
    tree = _mixed_tree(bits)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = interop.params_from_jax(tree)
    name = f"rq{bits}"
    jp = jcomp.codec(name).tree_encode_partitioned(
        jt, jax.random.PRNGKey(3), 4, bucket_elems=2048)
    tp = tcomp.codec(name).tree_encode_partitioned(
        tt, prng.PRNGKey(3), 4, bucket_elems=2048)
    np.testing.assert_array_equal(tp.payload.numpy(), np.asarray(jp.payload))
    np.testing.assert_array_equal(_u32(tp.params.numpy()), _u32(jp.params))
    assert (tp.part_elems, tp.n_parts) == (jp.part_elems, jp.n_parts)
    assert (tp.wire_bytes, tp.part_wire_bytes) == (jp.wire_bytes,
                                                   jp.part_wire_bytes)
    for p in range(4):          # a partition is a view of the backing buffer
        pay, par = tp.part(p)
        assert pay.data_ptr() == tp.payload[p].data_ptr()
        np.testing.assert_array_equal(_u32(par.numpy()), _u32(jp.part(p)[1]))
    want = jcomp.codec(name).flat_decode_partitioned(jp)
    got = tcomp.codec(name).flat_decode_partitioned(tp)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    back = tcomp.codec(name).tree_decode_partitioned(tp)
    for a, b in zip(pytree.tree_leaves(back),
                    jax.tree_util.tree_leaves(
                        jcomp.codec(name).tree_decode_partitioned(jp))):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    for n in (2, 4, 8):
        assert tcomp.codec(name).tree_wire_bytes_partitioned(tt, n) == \
            jcomp.codec(name).tree_wire_bytes_partitioned(jt, n)


def _stacked(n, seed):
    """A stacked (n workers) mixed gradient tree as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa
    return {"a": f(33), "b": {"w": f(7, 5), "z": f(1000)}, "c": [f(3)]}


def _jax_ring(ex, g, key):
    return jax.vmap(lambda gg: ex(gg, (), key, axis_name=AXIS),
                    axis_name=AXIS)(jax.tree_util.tree_map(jnp.asarray, g))


@pytest.mark.parametrize("n,partitioned,compressor", [
    (2, True, "rq8"), (3, True, "rq4"), (4, True, "rq4"), (4, True, "rq2"),
    (2, False, "rq4"), (3, False, "rq2"), (4, False, "rq8")])
def test_csgd_ring_bit_equal_to_jax_vmapped_exchange(n, partitioned,
                                                     compressor):
    """CSGDRingExchange on stacked gradients == JAX's exchange under vmap,
    bit for bit, for the partitioned and the monolithic chain; on the
    partitioned chain every worker ends bit-identical."""
    g = _stacked(n, seed=10 * n + len(compressor))
    jout, _ = _jax_ring(JC.CSGDRingExchange(compressor=compressor,
                                            partitioned=partitioned),
                        g, jax.random.PRNGKey(n))
    ex = TC.CSGDRingExchange(compressor=compressor, partitioned=partitioned)
    tg = interop.params_from_jax(g)
    keep = pytree.tree_map(torch.clone, tg)
    tout, state = ex(tg, ex.init(tg), prng.PRNGKey(n))
    assert state == ()
    for a, b, k in zip(pytree.tree_leaves(tout),
                       jax.tree_util.tree_leaves(jout),
                       pytree.tree_leaves(keep)):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    for a, b in zip(pytree.tree_leaves(tg), pytree.tree_leaves(keep)):
        assert torch.equal(a, b)                 # the input is untouched
    if partitioned:
        for a in pytree.tree_leaves(tout):
            for i in range(1, n):
                assert torch.equal(a[i].view(torch.int32),
                                   a[0].view(torch.int32))


def _reference_chains(g, key, n, *, bits, be):
    """Eq. (3.3) per partition, from the JAX package's flat_qdq at
    bucket_elems ``be``: partition p starts at worker p under
    fold_in(key, p) and is requantized at each downstream worker w under
    fold_in(fold_in(key, w), h) — tests/test_flat_codec.py's chains."""
    cdc = jcomp.codec(f"rq{bits}")
    gi = lambda i: jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf[i]),
                                          g)  # noqa: E731
    layout = jcomp.FlatLayout.from_tree(gi(0))
    pe, _, _ = cdc.partition_geometry(layout.total, n, bucket_elems=be)
    gparts = [np.asarray(jops.edge_pad(layout.flatten(gi(i)),
                                       n * pe)).reshape(n, pe)
              for i in range(n)]
    final = np.zeros((n, pe), np.float32)
    for p in range(n):
        acc = cdc.flat_qdq(jnp.asarray(gparts[p][p]),
                           jax.random.fold_in(key, p), bucket_elems=be)
        for h in range(1, n):
            w = (p + h) % n
            acc = cdc.flat_qdq(acc + jnp.asarray(gparts[w][p]),
                               jax.random.fold_in(
                                   jax.random.fold_in(key, w), h),
                               bucket_elems=be)
        final[p] = np.asarray(acc)
    return layout.unflatten(jnp.asarray(final.reshape(-1)[:layout.total]
                                        / n))


@pytest.mark.parametrize("n,bits", [(2, 8), (3, 4), (4, 4), (4, 2)])
def test_partitioned_ring_multi_bucket_equals_reference_chains(
        n, bits, monkeypatch):
    """At a small bucket cap every partition spans several buckets, so
    K5's plain version runs a head and a tail each hop; the result is
    the per-partition reference chains of the JAX package bit for bit,
    on every worker."""
    g = _stacked(n, seed=n + bits)
    g["b"]["z"] = np.random.default_rng(1).normal(
        size=(n, 20000)).astype(np.float32)
    be = 2048
    want = _reference_chains(g, jax.random.PRNGKey(5), n, bits=bits, be=be)
    monkeypatch.setattr(tcomp, "DEFAULT_BUCKET_ELEMS", be)
    ex = TC.CSGDRingExchange(compressor=f"rq{bits}")
    layout = tcomp.FlatLayout.from_tree(
        pytree.tree_map(lambda a: a[0], interop.params_from_jax(g)))
    _, nb_p, _ = ops.partition_geometry(layout.total, n, bits=bits,
                                        bucket_elems=be)
    assert nb_p >= 3
    tout, _ = ex(interop.params_from_jax(g), (), prng.PRNGKey(5))
    for a, b in zip(pytree.tree_leaves(tout), jax.tree_util.tree_leaves(want)):
        for i in range(n):
            np.testing.assert_array_equal(_u32(a[i].numpy()), _u32(b))


@pytest.mark.parametrize("compressor", ["rq8", "rq4", "rq2"])
def test_ring_message_bytes_and_wire_messages_equal_jax(compressor):
    tree = {"a": np.zeros((4096,), np.float32),
            "b": np.zeros((33, 65), np.float32)}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = interop.params_from_jax(tree)
    for n in (2, 4, 8):
        for part in (True, False):
            jex = JC.CSGDRingExchange(compressor=compressor,
                                      partitioned=part)
            tex = TC.CSGDRingExchange(compressor=compressor,
                                      partitioned=part)
            assert tex.message_bytes(tt, n_workers=n) == \
                jex.message_bytes(jt, n_workers=n)
            assert tex.n_wire_messages(n) == jex.n_wire_messages(n)
    # the partitioned ring ships 2(N-1) partition messages, under the
    # monolithic chain's (N-1) whole messages
    ring = TC.CSGDRingExchange(compressor=compressor)
    mono = TC.CSGDRingExchange(compressor=compressor, partitioned=False)
    assert ring.message_bytes(tt, n_workers=8) < \
        mono.message_bytes(tt, n_workers=8)


def test_full_width_ring_wire_bytes_from_the_geometry():
    """repro-100m at N = 4, rq4: 6 partition messages of 16,124,480 B
    = 96,746,880 B a worker, against 193,492,200 B for the monolithic
    chain and 1,031,952,384 B for fp32 mbsgd (the numbers the card's
    ring phase asserts)."""
    total = 128_994_048
    tree = {"w": torch.empty((total,), device="meta")}
    ring = TC.CSGDRingExchange(compressor="rq4")
    assert ops.partition_geometry(total, 4, bits=4) == (32_248_832, 8,
                                                        31_493)
    assert ring.message_bytes(tree, n_workers=4) == 96_746_880
    assert TC.CSGDRingExchange(compressor="rq4", partitioned=False
                               ).message_bytes(tree, n_workers=4) \
        == 193_492_200
    assert TC.MbSGDExchange().message_bytes(tree, n_workers=4) == \
        1_031_952_384


@pytest.mark.parametrize("bits", [8, 4])
def test_nan_code_packs_as_zero_like_xla(bits):
    """XLA casts a NaN code to uint8 as 0, where a C cast is undefined:
    the port's encode maps a NaN code to 0 explicitly (K2 and K5 do the
    same on the card), so a bucket whose sum holds NaN or Inf packs to
    JAX's bytes and params."""
    pack = 8 // bits
    pay, par, _ = _incoming(3 * pack * 2 * 512, bits, pack * 2 * 512,
                            seed=bits)
    pay = pay.reshape(3, 2, 512)
    rng = np.random.default_rng(bits)
    x4 = (rng.normal(size=(3, pack, 2, 512)) * 0.05).astype(np.float32)
    u4 = rng.random(size=x4.shape).astype(np.float32)
    x4[1, 0, 0, 7] = np.nan
    x4[2, 0, 1, 3] = np.inf
    want, want_p = jax.jit(jops._dae_ref, static_argnames="bits")(
        pay, par, x4, u4, bits=bits)
    got, got_p = ref.decode_add_encode_bucketed(
        torch.from_numpy(pay), torch.from_numpy(par), torch.from_numpy(x4),
        torch.from_numpy(u4), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.isnan(got_p.numpy()),
                                  np.isnan(np.asarray(want_p)))
    assert bool(got_p[1, 0].isnan()) and bool(got_p[2, 1].isinf())
    assert (got[1].numpy() == 0).all()          # every NaN code packs as 0


def test_k5_wrapper_refuses_overlapping_outputs():
    """An out or params_out that shares memory with an input raises on
    the CPU as on the card, whole or in part; disjoint outputs are
    written."""
    pay = torch.zeros((3, 1, 512), dtype=torch.uint8)
    prm = torch.ones((3, 2))
    x4 = torch.zeros((2, 2, 1, 512))
    key = prng.PRNGKey(0)

    def dae(pay, prm, loc, **kw):      # one worker, 2 buckets of 1 row
        return kernel.decode_add_encode_bucketed(
            [pay.view(-1, 512)], [prm], [loc.view(-1)], [key], bits=4,
            rows_b=1, rt=1, **kw)

    with pytest.raises(ValueError, match="out overlaps payload"):
        dae(pay[:2], prm[:2], x4, out=pay[:2].view(1, 2, 512))
    with pytest.raises(ValueError, match="out overlaps payload"):
        dae(pay[:2], prm[:2], x4, out=pay[1:].view(1, 2, 512))
    with pytest.raises(ValueError, match="params_out overlaps params"):
        dae(pay[:2], prm[:2], x4, params_out=prm[1:].view(1, 2, 2))
    with pytest.raises(ValueError, match="params_out overlaps locals_"):
        dae(pay[:2], prm[:2], x4, params_out=x4.view(-1)[:4].view(1, 2, 2))
    out, out_p = torch.empty((1, 2, 512), dtype=torch.uint8), \
        torch.empty(1, 2, 2)
    got, got_p = dae(pay[:2], prm[:2], x4, out=out, params_out=out_p)
    want, want_p = dae(pay[:2], prm[:2], x4)
    assert got is out and got_p is out_p
    assert torch.equal(got, want) and torch.equal(got_p, want_p)


def _jax_keyed_hop(pay, par, loc, key, *, bits, rows_b, rt):
    """The JAX package's hop of one granule-aligned partition: bucket b's
    uniforms drawn as jax.random.uniform(fold_in(key, b), (pack, R, 512)),
    the Pallas kernel in interpret mode on the full buckets and on the
    tail as B = 1, and jops._dae_ref on the same inputs."""
    pack, nb = 8 // bits, par.shape[0]
    head_rows = (nb - 1) * rows_b
    head_elems = head_rows * pack * 512
    groups = [(slice(0, nb - 1), pay[:head_rows].reshape(nb - 1, rows_b, 512),
               loc[:head_elems].reshape(nb - 1, pack, rows_b, 512), rows_b,
               range(nb - 1))] if nb > 1 else []
    groups.append((slice(nb - 1, nb), pay[head_rows:].reshape(1, rt, 512),
                   loc[head_elems:].reshape(1, pack, rt, 512), rt,
                   [nb - 1]))
    pal, ref_out = [], []
    for sl, p3, x4, r, buckets in groups:
        u4 = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, b), (pack, r, 512))) for b in buckets])
        pal.append(jkernel.decode_add_encode_bucketed(
            jnp.asarray(p3), jnp.asarray(par[sl]), jnp.asarray(x4),
            jnp.asarray(u4), bits=bits, block_r=8, interpret=True))
        ref_out.append(jax.jit(jops._dae_ref, static_argnames="bits")(
            p3, par[sl], x4, u4, bits=bits))
    cat = lambda outs: (  # noqa: E731
        np.concatenate([np.asarray(o).reshape(-1, 512) for o, _ in outs]),
        np.concatenate([np.asarray(q) for _, q in outs]))
    return cat(pal), cat(ref_out)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("nb,rows_b,rt", [(3, 4, 2), (1, 5, 5)])
def test_keyed_plain_equals_jax_draws_and_pallas_interpret(bits, nb, rows_b,
                                                           rt):
    """K5's keyed plain version (and the wrapper on CPU tensors) ==
    the Pallas kernel in interpret mode fed jax.random.uniform(fold_in(
    key, b), (pack, R, 512)) == jops._dae_ref on those draws, bit for
    bit: a multi-bucket head with a short tail, and a lone B = 1 bucket."""
    pack = 8 // bits
    rows = (nb - 1) * rows_b + rt
    pay, par, _ = _incoming(pack * rows * 512, bits, pack * rows_b * 512,
                            seed=nb + bits)
    assert par.shape == (nb, 2)
    loc = (np.random.default_rng(bits).normal(size=pack * rows * 512)
           * 0.05).astype(np.float32)
    (pal, pal_p), (want, want_p) = _jax_keyed_hop(
        pay, par, loc, jax.random.PRNGKey(11), bits=bits, rows_b=rows_b,
        rt=rt)
    got, got_p = ref.decode_add_encode_keyed(
        torch.from_numpy(pay), torch.from_numpy(par), torch.from_numpy(loc),
        prng.PRNGKey(11), bits=bits, rows_b=rows_b, rt=rt)
    for o, q in ((pal, pal_p), (want, want_p)):
        np.testing.assert_array_equal(got.numpy(), o)
        np.testing.assert_array_equal(_u32(got_p.numpy()), _u32(q))
    kernel.reset_launches()
    wo, wp = kernel.decode_add_encode_bucketed(
        [torch.from_numpy(pay)], [torch.from_numpy(par)],
        [torch.from_numpy(loc)], [prng.PRNGKey(11)], bits=bits,
        rows_b=rows_b, rt=rt)
    assert kernel.decode_add_encode_bucketed.launches == 0   # plain path
    assert torch.equal(wo[0], got) and torch.equal(wp[0], got_p)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_batched_hop_equals_single_worker_hops(n):
    """One hop of N workers (the ring's reduce-scatter unit: worker i's
    incoming message is worker i - 1's, its addend a window of the
    stacked gradient) == N one-worker decode_add_encode_flat calls, bit
    for bit, and leaves its inputs untouched."""
    bits, be = 4, 4096
    cdc = tcomp.codec(f"rq{bits}")
    part, nb, rows_p = ops.partition_geometry(n * 9000, n, bits=bits,
                                              bucket_elems=be)
    assert nb >= 3
    rng = np.random.default_rng(n)
    gparts = torch.from_numpy((rng.normal(size=(n, n, part)) * 0.05)
                              .astype(np.float32))
    msgs = [ops.encode_flat(gparts[i, i] * 2, prng.PRNGKey(i), bits=bits,
                            bucket_elems=be) for i in range(n)]
    keys = [prng.fold_in(prng.PRNGKey(100 + i), 1) for i in range(n)]
    pays = [msgs[(i - 1) % n][0] for i in range(n)]
    prms = [msgs[(i - 1) % n][1] for i in range(n)]
    locs = [gparts[i, (i - 1) % n] for i in range(n)]
    keep = [t.clone() for t in pays + prms + [gparts]]
    got, got_p = cdc.decode_add_encode_partitions(pays, prms, locs, keys,
                                                  bucket_elems=be)
    assert got.shape == (n, rows_p, 512) and got_p.shape == (n, nb, 2)
    for i in range(n):
        want, want_p = ops.decode_add_encode_flat(
            pays[i], prms[i], locs[i], keys[i], bits=bits, bucket_elems=be)
        assert torch.equal(got[i], want)
        assert torch.equal(got_p[i].view(torch.int32),
                           want_p.view(torch.int32))
    for a, b in zip(pays + prms + [gparts], keep):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="granule-aligned"):
        ops.decode_add_encode_partitions(pays, prms, [t[:-1] for t in locs],
                                         keys, bits=bits, bucket_elems=be)


def test_hop_key_table_equals_jax_fold_ins():
    """The key table K5 receives, fold_in(fold_in(wkey_i, h), b) per
    worker and bucket, computed on the host, == JAX's keys."""
    n, nb = 4, 9
    for h in (1, 2, 3):
        wkeys = [jax.random.fold_in(jax.random.PRNGKey(7), i)
                 for i in range(n)]
        want = np.stack([np.stack([np.asarray(jax.random.fold_in(
            jax.random.fold_in(wk, h), b), np.uint32) for b in range(nb)])
            for wk in wkeys])
        table = kernel.hop_keys(
            [prng.fold_in(prng.fold_in(prng.PRNGKey(7), i), h)
             for i in range(n)], nb)
        assert table.dtype == np.uint32 and table.shape == (n, nb, 2)
        np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("n,nb", [(4, 8), (4, 31), (9, 40), (2, 300),
                                  (1, 600), (17, 1)])
def test_hop_chunks_cover_every_bucket_within_the_argument_block(n, nb):
    """K5's launches for a hop: each within one launch's argument block
    (at most HOP_MAX_WORKERS workers, HOP_MAX_KEYS keys), together every
    (worker, bucket) once, in one launch when the hop fits it."""
    chunks = kernel.hop_chunks(n, nb)
    seen = []
    for w0, w1, b0, b1 in chunks:
        assert 0 < w1 - w0 <= kernel.HOP_MAX_WORKERS
        assert 0 < (w1 - w0) * (b1 - b0) <= kernel.HOP_MAX_KEYS
        seen += [(w, b) for w in range(w0, w1) for b in range(b0, b1)]
    assert sorted(seen) == [(w, b) for w in range(n) for b in range(nb)]
    fits = n <= kernel.HOP_MAX_WORKERS and n * nb <= kernel.HOP_MAX_KEYS
    assert (len(chunks) == 1) == fits


def test_threefry_check_entry_runs_only_on_the_card():
    """kernel.threefry is the card's hash alone, for holding it against
    core.prng: it refuses the CPU (prng.threefry2x32 is its plain
    version) and counters past 2**32."""
    key = prng.PRNGKey(3)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.threefry(key, 0, 2000, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        kernel.threefry(key, (1 << 32) - 10, 11, device="cpu")

"""The port on the card: the CUDA kernels (the codec's K1-K5, also as
the per-leaf launches, flash attention K6, the WKV6 scan K7) against
their plain versions, and the serving, training, per-leaf exchange,
int8-cache decode, prefill and embedding-frontend (M-RoPE, enc-dec)
paths on ``cuda``, and the training launcher on a world-1 NCCL group.
Every test needs an NVIDIA card (``cuda`` marker) and skips without one.

This file imports neither jax nor ``repro``, so it runs on a CUDA host
without JAX, skipping the suite's conftest (which imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.core import pytree
from repro_torch.kernels.quant import kernel, ops
from repro_torch.models import transformer_scan as tts
from repro_torch.core import prng

pytestmark = pytest.mark.cuda

# the kernels of the checkpoint codec (encode_flat / decode_flat)
CODEC_KERNELS = ("minmax_bucketed", "encode_packed", "decode_packed")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card: "
                    "python3 chip_smoke.py)")
    return torch.device("cuda")


def _same_bits(a, b) -> bool:
    """Equal bits where finite or infinite, NaN at the same places (a
    NaN's payload is not part of the result)."""
    a, b = a.cpu(), b.cpu()
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _data(n, seed=0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=n)
                             * 0.05).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("n,be", [(3 * 4096 + 1234, 4096), (77, 4096),
                                  (300_001, 1 << 22)])
def test_cuda_kernels_bit_equal_to_cpu_plain(card, bits, n, be):
    """encode_flat / decode_flat through K1-K3 on the card give the CPU
    plain versions' payload, params and decoded values, bit for bit."""
    x = _data(n, seed=n)
    kernel.reset_launches()
    pay, par = ops.encode_flat(x.to(card), prng.PRNGKey(4), bits=bits,
                               bucket_elems=be)
    dec = ops.decode_flat(pay, par, total=n, bits=bits, bucket_elems=be)
    assert all(kernel.launch_counts()[k] > 0 for k in CODEC_KERNELS)
    cpay, cpar = ops.encode_flat(x, prng.PRNGKey(4), bits=bits,
                                 bucket_elems=be)
    cdec = ops.decode_flat(cpay, cpar, total=n, bits=bits, bucket_elems=be)
    assert torch.equal(pay.cpu(), cpay)
    assert torch.equal(par.cpu().view(torch.int32), cpar.view(torch.int32))
    assert torch.equal(dec.cpu().view(torch.int32), cdec.view(torch.int32))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("n,be", [(3 * 4096 + 1234, 4096), (77, 4096),
                                  (300_001, 1 << 22)])
def test_cuda_qdq_flat_bit_equal_to_cpu_and_to_decode_encode(card, bits, n,
                                                             be):
    """qdq_flat through K1 + K4 on the card == the CPU plain version ==
    decode_flat(encode_flat) on the card, bit for bit; a bucket holding
    an Inf and a NaN comes out NaN in both."""
    x = _data(n, seed=n + bits)
    x[5] = float("inf")
    x[6] = float("nan")
    kernel.reset_launches()
    q = ops.qdq_flat(x.to(card), prng.PRNGKey(3), bits=bits,
                     bucket_elems=be)
    assert kernel.qdq_bucketed.launches == (2 if n > be else 1)
    cq = ops.qdq_flat(x, prng.PRNGKey(3), bits=bits, bucket_elems=be)
    assert _same_bits(q, cq)
    assert bool(q[:5].isnan().all())
    pay, par = ops.encode_flat(x.to(card), prng.PRNGKey(3), bits=bits,
                               bucket_elems=be)
    dec = ops.decode_flat(pay, par, total=n, bits=bits, bucket_elems=be)
    fin = torch.isfinite(par[:, 0]).cpu()
    keep = fin.repeat_interleave(ops.flat_geometry(
        n, bits=bits, bucket_elems=be)[1])[:n]
    assert _same_bits(q.cpu()[keep], dec.cpu()[keep])


def test_train_steps_on_the_card_match_the_cpu(card):
    """Two reduced rq4 + EF steps on the card: the losses match the
    CPU's, and the codec stage given the same gradient is bit-equal."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    mc = configs.get_config("repro-100m").reduced()
    scfg = steps.TrainStepConfig(grad_compression="rq4",
                                 error_feedback=True)
    opt = adamw(1e-3)
    st_c = steps.init_train_state(mc, opt, prng.PRNGKey(0), step_cfg=scfg,
                                  device="cpu")
    st_g = steps.state_to(st_c, card)
    step = steps.make_train_step(mc, opt, scfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, mc.vocab, size=(2, 33)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    kernel.reset_launches()
    for _ in range(2):
        st_c, mc_ = step(st_c, batch)
        st_g, mg_ = step(st_g, {k: v.to(card) for k, v in batch.items()})
        assert abs(float(mc_["loss"]) - float(mg_["loss"])) < 1e-4
    assert kernel.qdq_bucketed.launches == 2
    g = [torch.from_numpy(np.random.default_rng(i).normal(
        size=t.shape).astype(np.float32))
        for i, t in enumerate(pytree.tree_leaves(st_c["params"]))]
    tree_c = pytree.tree_unflatten(pytree.tree_flatten(st_c["params"])[1], g)
    tree_g = pytree.tree_map(lambda t: t.to(card), tree_c)
    from repro_torch.core import compression
    codec = compression.codec("rq4")
    err = st_c["ec_err"]
    qc, ec, _ = steps.compress_grads(codec, tree_c, prng.PRNGKey(9),
                                     err.clone())
    qg, eg, _ = steps.compress_grads(codec, tree_g, prng.PRNGKey(9),
                                     err.to(card))
    assert torch.equal(eg.cpu().view(torch.int32), ec.view(torch.int32))
    for a, b in zip(pytree.tree_leaves(qg), pytree.tree_leaves(qc)):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_wrappers_refuse_bad_cuda_inputs(card):
    x = torch.zeros((2, 1, 512), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.minmax_bucketed(torch.zeros((2, 2, 512), device=card)[:, :1])
    with pytest.raises(ValueError, match="expected"):
        kernel.encode_packed(x.view(2, 1, 1, 512), prng.PRNGKey(0),
                             torch.zeros((2, 2)), bits=8)        # CPU params
    with pytest.raises(TypeError, match="dtype"):
        kernel.decode_packed(torch.zeros((1, 1, 512), device=card),
                             torch.zeros((1, 2), device=card), bits=8)
    with pytest.raises(ValueError, match="expected"):
        kernel.qdq_bucketed(x.view(2, 1, 1, 512), prng.PRNGKey(0),
                            torch.zeros((2, 2)), bits=8)         # CPU params
    with pytest.raises(ValueError, match="aligned"):
        kernel.qdq_bucketed(torch.zeros(1025, device=card)[1:].view(
            2, 1, 1, 512), prng.PRNGKey(0),
            torch.zeros((2, 2), device=card), bits=8)


# K2 and K4 draw their uniforms on the card (csrc/threefry.cuh): held
# against their plain versions (prng draws, then the TPU kernel's function)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("b,first", [(3, 0), (1, 7)])
def test_keyed_k2_k4_bucketed_bit_equal_to_plain(card, bits, b, first):
    """K2 and K4 with bucket b drawing under fold_in(key, first + b):
    head buckets from 0 (bucket 1 holding an Inf, bucket 2 a NaN) and a
    tail bucket (B = 1) from 7, against ref.encode_packed_keyed /
    ref.qdq_keyed on the same card tensors, bit for bit, one launch each;
    K4 in place gives the same bits, and K4 == K3(K2(x)) where finite."""
    from repro_torch.kernels.quant import ref
    pack = 8 // bits
    g = torch.Generator(device=card).manual_seed(bits + b)
    x4 = torch.randn((b, pack, 24, 512), generator=g, device=card) * 0.05
    if b > 1:
        x4[1, 0, 1, 7] = float("inf")
        x4[b - 1, pack - 1, 2, 9] = float("nan")
    params = ops.bucket_params(x4.view(b, -1), bits=bits)
    key = prng.PRNGKey(40 + bits)
    kernel.reset_launches()
    q = kernel.qdq_bucketed(x4, key, params, bits=bits, first_bucket=first)
    pay = kernel.encode_packed(x4, key, params, bits=bits,
                               first_bucket=first)
    assert (kernel.qdq_bucketed.launches,
            kernel.encode_packed.launches) == (1, 1)
    keys = ref.fold_keys(key, first, b)
    lo, scale = params[:, 0], params[:, 1]
    assert _same_bits(q, ref.qdq_keyed(x4, keys, lo, scale, bits=bits))
    assert torch.equal(pay, ref.encode_packed_keyed(x4, keys, lo, scale,
                                                    bits=bits))
    inplace = x4.clone()
    kernel.qdq_bucketed(inplace, key, params, bits=bits, first_bucket=first,
                        out=inplace)
    assert _same_bits(inplace, q)
    fin = torch.isfinite(params).all(dim=1)
    dec = kernel.decode_packed(pay, params, bits=bits)
    assert _same_bits(q[fin], dec[fin])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_keyed_leaf_k2_k4_over_repeated_keys_and_many_rows(card, bits):
    """leaf_qdq / leaf_encode_packed with one key a row over
    ROW_MAX_KEYS + 44 leaves (two launches, one count), keys repeating
    every 7 rows over rows of equal data: bit for bit their plain
    versions, and equal keys give equal rows."""
    from repro_torch.kernels.quant import ref
    n_rows = kernel.ROW_MAX_KEYS + 44
    g = torch.Generator(device=card).manual_seed(bits)
    x = torch.randn((7, 1000), generator=g, device=card).repeat(
        n_rows // 7 + 1, 1)[:n_rows] * 0.02
    keys = [prng.PRNGKey(i % 7) for i in range(n_rows)]
    x4, params = ops._leaf_rows(x, keys, bits=bits)
    kernel.reset_launches()
    q = kernel.leaf_qdq(x4, keys, params, bits=bits)
    pay = kernel.leaf_encode_packed(x4, keys, params, bits=bits)
    assert (kernel.leaf_qdq.launches,
            kernel.leaf_encode_packed.launches) == (1, 1)
    lo, scale = params[:, 0], params[:, 1]
    assert _same_bits(q, ref.qdq_keyed(x4, keys, lo, scale, bits=bits))
    assert torch.equal(pay, ref.encode_packed_keyed(x4, keys, lo, scale,
                                                    bits=bits))
    assert torch.equal(q[0], q[7]) and torch.equal(q[0], q[n_rows - 6])
    assert torch.equal(pay[3], pay[3 + 7 * 37])      # across the launches


def test_qdq_flat_allocates_less_than_one_buckets_uniforms(card):
    """qdq_flat over 8 full 4Mi buckets, donated: K4 draws on the card,
    so the call allocates less than one bucket's 16 MiB of uniforms
    (drawing them in torch would take 8 x 16 MiB)."""
    be = ops.DEFAULT_BUCKET_ELEMS
    x = torch.randn(8 * be, device=card)
    want = ops.qdq_flat(x.cpu(), prng.PRNGKey(2), bits=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    q = ops.qdq_flat(x, prng.PRNGKey(2), bits=4, donate=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert q.data_ptr() == x.data_ptr()
    assert extra < be * 4, extra
    assert _same_bits(q, want)


def test_k1_bit_equal_on_nan_and_inf_buckets_over_calls_of_two_sizes(card):
    """K1 against its plain version bit for bit (NaN at the same places)
    on buckets holding NaN, +Inf and -Inf, in two calls of different
    bucket counts and then the first again: each call is one launch, and
    the ticket counters its last blocks reset leave the next call
    right."""
    from repro_torch.kernels.quant import ref
    g = torch.Generator().manual_seed(11)
    for nb, r in ((5, 64), (111, 3), (5, 64)):
        x = torch.randn((nb, r, 512), generator=g)
        x[0, r // 2, 7] = float("nan")
        x[1, r - 1, 511] = float("inf")
        x[2, 0, 0] = float("-inf")
        x[3, 1, 3] = float("inf")
        x[3, 0, 9] = float("-inf")
        kernel.reset_launches()
        got = kernel.minmax_bucketed(x.to(card))
        assert kernel.minmax_bucketed.launches == 1
        lo, hi = ref.minmax_bucketed(x)
        assert _same_bits(got, torch.stack([lo, hi], dim=1))


def test_k1_refuses_an_unaligned_input(card):
    buf = torch.zeros(2 * 512 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.minmax_bucketed(buf[1:].view(2, 1, 512))


def test_serving_on_the_card_swaps_and_matches_a_cold_start(card):
    cfg = serve.ServeConfig(slots=2, max_len=32, prompt_len=6, n_requests=3,
                            mixed_gen=(3, 5), seed=1)
    eng = serve.Engine(cfg)                         # cuda by default
    assert eng.device.type == "cuda"
    ch = serve.CheckpointChannel()
    eng.subscribe(ch)
    for r in serve.synthetic_requests(cfg):
        eng.submit(r.tokens, r.max_new_tokens, rid=r.rid)
    eng.step()
    new = tts.init(eng.model_cfg, tts.generator(5, card))
    kernel.reset_launches()
    pub = ch.publish(new, step=1)
    eng.run()
    assert eng.counters["swaps"] == 1 and eng.counters["completed"] == 3
    assert all(kernel.launch_counts()[k] > 0 for k in CODEC_KERNELS)
    # the card's publish equals the CPU's, byte for byte
    cpu = serve.CheckpointChannel().publish(
        pytree.tree_map(lambda a: a.cpu(), new), step=1)
    assert pub.crc == cpu.crc
    assert torch.equal(pub.packed.payload.cpu(), cpu.packed.payload)
    prompt = np.arange(6, dtype=np.int32)
    rid = eng.submit(prompt, 4)
    eng.run()
    cold = serve.Engine(cfg, params=serve.CheckpointChannel.decode(pub))
    cid = cold.submit(prompt, 4)
    cold.run()
    assert eng.result(rid).tokens == cold.result(cid).tokens


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_k5_bit_equal_to_cpu_plain(card, bits):
    """decode_add_encode_flat through K5 on the card (a multi-bucket head
    and a short tail) gives the CPU plain version's payload and params,
    bit for bit, in one K5 call over the head and the tail."""
    granule = (8 // bits) * 512
    n = 5 * 4096 + 3 * granule
    x, loc = _data(n, seed=bits), _data(n, seed=bits + 10)
    pay, par = ops.encode_flat(x, prng.PRNGKey(1), bits=bits,
                               bucket_elems=4096)
    kernel.reset_launches()
    got, got_p = ops.decode_add_encode_flat(pay.to(card), par.to(card),
                                            loc.to(card), prng.PRNGKey(2),
                                            bits=bits, bucket_elems=4096)
    assert kernel.decode_add_encode_bucketed.launches == 1
    want, want_p = ops.decode_add_encode_flat(pay, par, loc, prng.PRNGKey(2),
                                              bits=bits, bucket_elems=4096)
    assert torch.equal(got.cpu(), want)
    assert _same_bits(got_p, want_p)


def test_reduced_ring_exchange_on_the_card_matches_the_cpu(card,
                                                          monkeypatch):
    """The partitioned rq4 ring over 4 stacked workers, partitions of
    several buckets: the card's result equals the CPU's bit for bit, and
    every worker holds the same bits; one K5 call (one count) a hop."""
    from repro_torch.core import communicators, compression
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(4, 30000)).astype(
        np.float32)), "b": [torch.from_numpy(rng.normal(size=(4, 7, 3))
                                             .astype(np.float32))]}
    monkeypatch.setattr(compression, "DEFAULT_BUCKET_ELEMS", 2048)
    ring = communicators.CSGDRingExchange(compressor="rq4")
    kernel.reset_launches()
    got, _ = ring(pytree.tree_map(lambda t: t.to(card), g), (),
                  prng.PRNGKey(3))
    assert kernel.decode_add_encode_bucketed.launches == 3
    want, _ = ring(g, (), prng.PRNGKey(3))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
        assert all(torch.equal(a[i], a[0]) for i in range(4))


def test_k5_wrapper_refuses_bad_cuda_inputs(card):
    pay = torch.zeros((2, 512), dtype=torch.uint8, device=card)
    par = torch.ones((2, 2), device=card)
    loc = torch.zeros((2 * 2 * 512,), device=card)
    key = prng.PRNGKey(0)
    kernel.reset_launches()

    def dae(pay=pay, par=par, loc=loc, n=1, **kw):
        # n workers of 2 buckets of one row each, rq4
        return kernel.decode_add_encode_bucketed(
            [pay] * n, [par] * n, [loc] * n, [key] * n, bits=4, rows_b=1,
            rt=1, **kw)

    with pytest.raises(TypeError, match="dtype"):
        dae(pay=pay.float())
    with pytest.raises(ValueError, match="locals_"):
        dae(loc=loc[:1024])
    with pytest.raises(ValueError, match="expected"):
        dae(par=par.cpu())
    with pytest.raises(ValueError, match="out overlaps payload"):
        dae(out=pay.view(1, 2, 512))
    with pytest.raises(ValueError, match="params_out overlaps params"):
        dae(params_out=par.view(1, 2, 2))
    # partial overlaps: windows of one larger buffer
    big = torch.zeros((3, 512), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="out overlaps payload"):
        dae(pay=big[:2], out=big[1:].view(1, 2, 512))
    prm = torch.ones((3, 2), device=card)
    with pytest.raises(ValueError, match="params_out overlaps params"):
        dae(par=prm[:2], params_out=prm[1:].view(1, 2, 2))
    # views that are not 16-byte aligned
    flat = torch.zeros((2 * 2 * 512 + 1,), device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dae(loc=flat[1:])
    raw = torch.zeros((2 * 512 + 4,), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dae(pay=raw[4:].view(2, 512))
    assert kernel.decode_add_encode_bucketed.launches == 0


@pytest.mark.parametrize("n,nb", [(kernel.HOP_MAX_WORKERS + 1, 40),
                                  (2, kernel.HOP_MAX_KEYS + 44)])
def test_k5_hop_beyond_one_argument_block_bit_equal_to_cpu_plain(card, n,
                                                                 nb):
    """A hop of more workers, or more (worker, bucket) keys, than one
    launch's argument block holds: one call and one count, several
    launches of whole buckets, the CPU plain version's messages bit for
    bit (tail bucket included)."""
    be, bits = 4096, 4
    part = (nb - 1) * be + 3 * 1024
    g = _data(n * part, seed=nb).view(n, part)
    msgs = [ops.encode_flat(g[i], prng.PRNGKey(i), bits=bits,
                            bucket_elems=be) for i in range(n)]
    loc = _data(n * part, seed=nb + 1).view(n, part)
    keys = [prng.fold_in(prng.PRNGKey(70 + i), 1) for i in range(n)]

    def hop(dev):
        ld = loc.to(dev)
        return ops.decode_add_encode_partitions(
            [p.to(dev) for p, _ in msgs], [q.to(dev) for _, q in msgs],
            [ld[i] for i in range(n)], keys, bits=bits, bucket_elems=be)

    assert len(kernel.hop_chunks(n, nb)) > 1
    kernel.reset_launches()
    got, got_p = hop(card)
    assert kernel.decode_add_encode_bucketed.launches == 1
    want, want_p = hop("cpu")
    assert got_p.shape == (n, nb, 2)
    assert torch.equal(got.cpu(), want)
    assert _same_bits(got_p, want_p)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_k5_hop_of_four_workers_bit_equal_to_cpu_plain(card, bits):
    """One K5 launch over 4 workers reading views (worker i's incoming
    message is i - 1's, its addend a window of a stacked buffer), with a
    bucket holding Inf and NaN: the CPU plain version's messages bit for
    bit."""
    n, be = 4, 4096
    part, nb, rows_p = ops.partition_geometry(n * 15000, n, bits=bits,
                                              bucket_elems=be)
    g = torch.stack([_data(n * part, seed=bits + i).view(n, part)
                     for i in range(n)])
    g[1, 0, 5] = float("inf")
    g[2, 1, be + 3] = float("nan")
    msgs = [ops.encode_flat(g[i, i], prng.PRNGKey(i), bits=bits,
                            bucket_elems=be) for i in range(n)]
    keys = [prng.fold_in(prng.PRNGKey(50 + i), 2) for i in range(n)]

    def hop(dev):
        gd = g.to(dev)
        ms = [(p.to(dev), q.to(dev)) for p, q in msgs]
        return ops.decode_add_encode_partitions(
            [ms[(i - 1) % n][0] for i in range(n)],
            [ms[(i - 1) % n][1] for i in range(n)],
            [gd[i, (i - 1) % n] for i in range(n)], keys, bits=bits,
            bucket_elems=be)

    kernel.reset_launches()
    got, got_p = hop(card)
    assert kernel.decode_add_encode_bucketed.launches == 1
    want, want_p = hop("cpu")
    assert got.shape == (n, rows_p, 512)
    assert torch.equal(got.cpu(), want)
    assert _same_bits(got_p, want_p)
    assert not bool(got_p[1].isfinite().all())       # the Inf
    assert bool(got_p[2].isnan().any())               # the NaN


def test_device_threefry_equals_prng(card):
    """The card's Threefry (K5's draws) == prng.random_bits / prng.uniform
    bit for bit over 4Mi counters from several offsets (across 2**24 and
    near 2**32) and keys."""
    n = 1 << 22
    for seed in (0, 1, 12345):
        key = prng.PRNGKey(seed)
        bits = kernel.threefry(key, 0, n, device=card)
        assert torch.equal(bits, prng.random_bits(key, (n,), device=card))
        unit = kernel.threefry(key, 0, n, device=card, unit=True)
        assert torch.equal(unit.view(torch.int32),
                           prng.uniform(key, (n,), device=card)
                           .view(torch.int32))
    key = prng.fold_in(prng.PRNGKey(9), 3)
    for offset in ((1 << 24) - (1 << 21), (1 << 32) - n):
        lo = torch.arange(offset, offset + n, dtype=torch.int64, device=card)
        y0, y1 = prng.threefry2x32(*prng.key_words(key), torch.zeros_like(lo),
                                   lo)
        assert torch.equal(kernel.threefry(key, offset, n, device=card),
                           y0 ^ y1)
    want = prng.random_bits(key, ((1 << 24) + 1000,), device=card)
    got = kernel.threefry(key, (1 << 24) - 1000, 2000, device=card)
    assert torch.equal(got, want[-2000:])


# ----------------------------------------------------------- K6 flash ----

def _qkv(b, s, hq, hkv, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)).to(dtype) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,cap,s", [
    (True, 0, 0.0, 256),        # causal
    (True, 96, 0.0, 320),       # sliding window
    (False, 0, 0.0, 192),       # non-causal, padded tail (s_valid 182)
    (True, 0, 30.0, 256),       # softcap
])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 4), (6, 1)])
def test_k6_matches_plain_and_skip_equals_full(card, d, causal, window, cap,
                                               s, hq, hkv):
    """K6 against its plain version (the CPU tensors' path) at rtol =
    atol = 2e-5 (fp32 sums in another order), and skip == full grid bit
    for bit on the card."""
    from repro_torch.kernels.flash_attn import kernel as fk
    q, k, v = _qkv(2, s, hq, hkv, d, seed=d + s + hq)
    s_valid = s - 10 if not causal else s
    kw = dict(causal=causal, window=window, softcap=cap, block_q=64,
              block_k=64, s_valid=s_valid)
    fk.reset_launches()
    got = fk.flash_attention_bhsd(q.to(card), k.to(card), v.to(card), **kw)
    full = fk.flash_attention_bhsd(q.to(card), k.to(card), v.to(card),
                                   skip=False, **kw)
    assert fk.flash_attention_bhsd.launches == 2
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, full)


def test_k6_bf16_and_entry_point(card):
    """bf16 in and out (tolerance 0.05, as the JAX package's bf16 test);
    the public (B, S, H, D) entry point with an odd length launches K6
    once and matches the plain path."""
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fo
    q, k, v = _qkv(1, 128, 4, 2, 64, seed=3, dtype=torch.bfloat16)
    kw = dict(causal=True, window=0, softcap=0.0, block_q=64, block_k=64,
              s_valid=128)
    got = fk.flash_attention_bhsd(q.to(card), k.to(card), v.to(card), **kw)
    assert got.dtype == torch.bfloat16
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0.05,
                               atol=0.05)
    q, k, v = (t.float().transpose(1, 2)[:, :97].contiguous()
               for t in (q, k, v))
    fk.reset_launches()
    got = fo.flash_attention(q.to(card), k.to(card), v.to(card))
    assert fk.flash_attention_bhsd.launches == 1
    torch.testing.assert_close(got.cpu(), fo.flash_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_k6_refuses_bad_inputs_and_a_refused_launch_raises(card):
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fo
    kw = dict(causal=True, window=0, softcap=0.0, block_q=64, block_k=64,
              s_valid=8)
    q, k, v = (t.to(card) for t in _qkv(1, 8, 4, 2, 48, seed=1))
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_bhsd(q, k, v, **kw)
    q, k, v = (t.to(card) for t in _qkv(1, 8, 4, 2, 64, seed=1))
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_bhsd(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_bhsd(q.transpose(2, 3).contiguous().transpose(
            2, 3), k, v, **kw)
    with pytest.raises(ValueError, match="multiple"):
        fk.flash_attention_bhsd(q[:, :3].contiguous(), k, v, **kw)
    # gridDim.z = B above 65,535: the launch is refused and raises
    q, k, v = (torch.zeros((70_000, h, 1, 32), device=card)
               for h in (1, 1, 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.flash_attention_bhsd(q, k, v, **dict(kw, s_valid=1))
    # the backward on the card: what K6b does not cover (D 32, bf16,
    # softcap) raises one NotImplementedError; K6b checks its inputs
    q, k, v = (t.to(card).transpose(1, 2).requires_grad_(True)
               for t in _qkv(1, 16, 2, 2, 32, seed=2))
    with pytest.raises(NotImplementedError, match="head_dim"):
        fo.flash_attention(q, k, v).sum().backward()
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="with_lse"):
        fk.flash_attention_bhsd(qt, kt, vt, with_lse=True,
                                **dict(kw, s_valid=16))
    bw = dict(causal=True, window=0, s_valid=16)
    lse = torch.zeros(qt.shape[:3], device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_bwd_bhsd(qt, kt, vt, qt, qt, lse, **bw)
    q, k, v = (t.to(card).transpose(1, 2).requires_grad_(True)
               for t in _qkv(1, 16, 2, 2, 64, seed=2))
    with pytest.raises(NotImplementedError, match="softcap"):
        fo.flash_attention(q, k, v, softcap=30.0).sum().backward()
    with pytest.raises(NotImplementedError, match="float32"):
        fo.flash_attention(*(t.detach().bfloat16().requires_grad_(True)
                             for t in (q, k, v))).sum().backward()
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().bfloat16()
                  for t in (q, k, v))
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_bwd_bhsd(qt, kt, vt, qt, qt, lse, **bw)
    fk.reset_launches()
    grads = torch.autograd.grad(fo.flash_attention(q, k, v).sum(), (q, k, v))
    assert fk.flash_attention_bwd_bhsd.launches == 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fo.flash_attention(*cpu).sum(), cpu)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,s", [(True, 256), (False, 192),
                                      (True, 320)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)])
def test_k6_at_mla_head_dims_matches_plain(card, causal, s, hq, hkv):
    """K6 at (D 192, DV 128), multi-head latent attention's q.k and p.v
    widths, with a softmax scale of its own (YaRN's), against its plain
    version at rtol = atol = 2e-5 (fp32 sums in another order); skip ==
    full grid bit for bit; a (D, DV) pair K6 does not build raises."""
    from repro_torch.kernels.flash_attn import kernel as fk
    rng = np.random.default_rng(s + hq)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, h, s, d)).astype(
        np.float32)) for h, d in ((hq, 192), (hkv, 192), (hkv, 128)))
    kw = dict(causal=causal, window=0, softcap=0.0, block_q=64, block_k=64,
              s_valid=s if causal else s - 10, scale=0.114721)
    fk.reset_launches()
    got = fk.flash_attention_bhsd(q.to(card), k.to(card), v.to(card), **kw)
    full = fk.flash_attention_bhsd(q.to(card), k.to(card), v.to(card),
                                   skip=False, **kw)
    assert fk.flash_attention_bhsd.launches == 2
    assert got.shape == (2, hq, s, 128)
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, full)
    with pytest.raises(ValueError, match="head dims"):
        fk.flash_attention_bhsd(q.to(card)[..., :128].contiguous(),
                                k.to(card)[..., :128].contiguous(),
                                v.to(card)[..., :64].contiguous(), **kw)
    with pytest.raises(ValueError, match="head dims"):
        fk.flash_attention_bhsd(q.to(card).bfloat16(), k.to(card).bfloat16(),
                                v.to(card).bfloat16(), **kw)


def test_mla_prefill_on_the_card_runs_k6_and_matches_the_cpu(card):
    """A small DeepSeek-V2-Lite (3 layers, the published MLA head dims:
    q.k 128 + 64, v 128; YaRN; dropless MoE) prefills on the card with
    K6 once an MLA layer and equals the CPU's plain MLA path within
    2e-5 of the logits' scale; a gradient through K6 at these dims
    raises (no backward kernel covers them)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models.common import MLAConfig
    from repro_torch.train import steps
    base = configs.get_config("deepseek-v2-lite")
    mc = dataclasses.replace(
        base.reduced(n_layers=3), mla=MLAConfig(
            kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    params = tts.init(mc, tts.generator(5))
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, mc.vocab, size=(1, 300)).astype(np.int32))
    step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    want = step(params, {"tokens": tok})
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    fk.reset_launches()
    got = step(gparams, {"tokens": tok.to(card)})
    assert fk.flash_attention_bhsd.launches == mc.n_layers
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-5 * scale)
    gp = pytree.tree_map(lambda t: t.requires_grad_(True), gparams)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tts.apply(gp, mc, {"tokens": tok[:, :64].to(card)},
                  use_flash=True).sum().backward()


# ------------------------------------------------------ K6b flash bwd ----

def _masked_logits(q, k, *, causal, window, s_valid):
    """(B, Hq, S, S) fp64 logits of q . k / sqrt(D), the heads of k
    repeated to the group, masked to -inf."""
    b, hq, s, d = q.shape
    kr = k.repeat_interleave(hq // k.shape[1], dim=1)
    logits = (q.double() @ kr.double().transpose(-1, -2)) / d ** 0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None]
    mask = kp < s_valid
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return logits.masked_fill(~mask, float("-inf"))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,s,s_valid", [
    (True, 0, 256, 256),        # causal
    (True, 96, 320, 320),       # sliding window
    (False, 0, 192, 182),       # non-causal, padded tail
    (True, 0, 97, 97),          # a length off every tile
])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 4), (6, 1)])
def test_k6b_matches_plain_and_k6_writes_the_lse(card, d, causal, window,
                                                  s, s_valid, hq, hkv):
    """K6's lse output against torch.logsumexp of the masked, scaled
    logits (fp64; -inf on no row here); K6b against its plain version on
    the card at rtol = atol = 1e-4 (the card's chip runs read ~1e-5 at
    most: 3xTF32 products, other summation orders, P recomputed), and
    two K6b calls bit for bit (no atomics)."""
    from repro_torch.kernels.flash_attn import kernel as fk
    q, k, v, dout = (t.to(card) for t in _qkv(2, s, hq, hkv, d, seed=d + s)
                     + [_qkv(2, s, hq, hkv, d, seed=d + s + 1)[0]])
    kw = dict(causal=causal, window=window, softcap=0.0, block_q=s,
              block_k=s, s_valid=s_valid)
    out, lse = fk.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    want_lse = torch.logsumexp(_masked_logits(q, k, causal=causal,
                                              window=window,
                                              s_valid=s_valid), -1)
    torch.testing.assert_close(lse.double(), want_lse, rtol=1e-5,
                               atol=1e-5)
    bw = dict(causal=causal, window=window, s_valid=s_valid)
    fk.reset_launches()
    got = fk.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, **bw)
    again = fk.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, **bw)
    assert fk.flash_attention_bwd_bhsd.launches == 2
    want = fk.flash_attention_backward_plain(q, k, v, out, dout, lse, **bw)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(8, 16, 16, 2048, 64),
                                          (1, 32, 8, 2048, 128)],
                         ids=["train", "gqa-d128"])
def test_k6b_at_full_geometry_matches_plain_and_autograd(card, b, hq, hkv,
                                                         s, d):
    """The train cell's attention (8 x 16/16 x 2,048 x 64, causal) and
    GQA 32/8 at D 128: the entry point's gradient (K6 with lse, then
    K6b) against the plain backward on the card and against autograd
    through ``sdpa_reference`` (fp32, TF32 off), at rtol = atol = 1e-4;
    a second backward gives the same bits."""
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fo
    from repro_torch.models import attention as tattn
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(b + d)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=card)
               .requires_grad_(True) for h in (hq, hkv, hkv))
    dout = torch.randn((b, s, hq, d), generator=g, device=card)
    fk.reset_launches()
    out = fo.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), dout)
    assert fk.flash_attention_bhsd.launches == 1
    assert fk.flash_attention_bwd_bhsd.launches == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous() for t in (q, k, v))
    o, lse = fk.flash_attention_bhsd(qt, kt, vt, causal=True, window=0,
                                     softcap=0.0, block_q=256, block_k=128,
                                     s_valid=s, with_lse=True)
    plain = fk.flash_attention_backward_plain(
        qt, kt, vt, o, dout.transpose(1, 2).contiguous(), lse, causal=True,
        window=0, s_valid=s)
    for a, w in zip(got, plain):
        torch.testing.assert_close(a, w.transpose(1, 2), rtol=1e-4,
                                   atol=1e-4)
    del plain, o, lse
    mask = tattn.make_mask(s, s, causal=True, device=card)[None]
    ref = torch.autograd.grad(tattn.sdpa_reference(q, k, v, mask),
                              (q, k, v), dout)
    for a, w in zip(got, ref):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_reduced_train_step_takes_k6_and_k6b_once_a_layer_and_pass(card,
                                                                   remat):
    """A reduced repro-100m train step on the card (fp32, D 64: the
    route) launches K6 once a layer in the forward (and once more in
    remat's recompute) and K6b once a layer, with ``use_flash`` unset;
    its loss and gradients equal the CPU's (plain attention, no
    launch) within 1e-5."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.train import steps
    mc = configs.get_config("repro-100m").reduced()
    params = tts.init(mc, tts.generator(3))
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, mc.vocab, size=(2, 65)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True,
                                                        remat=remat))
    fk.reset_launches()
    want_l, want_g = steps.value_and_grad(loss, params, batch)
    assert fk.flash_attention_bhsd.launches == 0
    got_l, got_g = steps.value_and_grad(
        loss, gparams, {k: t.to(card) for k, t in batch.items()})
    assert fk.flash_attention_bhsd.launches == mc.n_layers * (1 + remat)
    assert fk.flash_attention_bwd_bhsd.launches == mc.n_layers
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for g, w in zip(pytree.tree_leaves(got_g), pytree.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


def test_no_grad_prefill_launches_no_k6b_and_writes_no_lse(card,
                                                           monkeypatch):
    """The prefill (no grad) launches K6 once a layer with a null lse
    pointer and no K6b, as before the backward existed; a forward with
    grad on the same parameters asks K6 for the lse."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.train import steps
    asked = []
    real = fk.flash_attention_bhsd

    def spy(*a, **kw):
        asked.append(kw.get("with_lse", False))
        return real(*a, **kw)
    monkeypatch.setattr(fk, "flash_attention_bhsd", spy)
    mc = configs.get_config("repro-100m").reduced()
    params = pytree.tree_map(lambda t: t.to(card),
                             tts.init(mc, tts.generator(5)))
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, mc.vocab, size=(2, 300)).astype(np.int32)).to(card)
    step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    fk.reset_launches()        # the kernel counts on the spy's name now
    step(params, {"tokens": tok})
    assert asked == [False] * mc.n_layers
    assert spy.launches == mc.n_layers
    assert fk.flash_attention_bwd_bhsd.launches == 0
    asked.clear()
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
    steps.value_and_grad(loss, params, {"tokens": tok[:, :64],
                                        "labels": tok[:, 1:65]})
    assert asked == [True] * mc.n_layers
    assert fk.flash_attention_bwd_bhsd.launches == mc.n_layers


# ------------------------------------------------------------- K7 wkv6 ----

def _wkv(b, h, s, dk, seed, regime="tests"):
    """r, k, v, log_w (B, H, S, K), u (H, K), state0 (B, H, K, K) on the
    CPU: the JAX tests' decays, or rwkv6-3b's own at init ("model")."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, dk)) * 0.5 for _ in range(3))
    if regime == "model":
        lw = -np.exp(-6.0 + 0.3 * np.tanh(rng.normal(size=(b, h, s, dk))))
    else:
        lw = -np.exp(rng.normal(size=(b, h, s, dk)) * 0.5 - 2.0)
    u = rng.normal(size=(h, dk)) * 0.1
    s0 = rng.normal(size=(b, h, dk, dk)) * 0.1
    return [torch.from_numpy(np.asarray(a, np.float32))
            for a in (r, k, v, lw, u, s0)]


@pytest.mark.parametrize("regime", ["tests", "model"])
@pytest.mark.parametrize("b,h,s,dk", [(2, 2, 128, 64), (1, 4, 128, 32),
                                      (2, 1, 192, 64), (1, 3, 64, 32)])
def test_k7_matches_the_cpu_plain_version(card, b, h, s, dk, regime):
    """K7 against its plain version on the CPU (rtol = atol = 1e-4, the
    JAX package's kernel tolerance), out and final state."""
    from repro_torch.kernels.wkv6 import kernel as wk
    r, k, v, lw, u, _ = _wkv(b, h, s, dk, seed=s + h + dk)
    wk.reset_launches()
    got_o, got_s = wk.wkv6_bhsk(*(t.to(card) for t in (r, k, v, lw, u)))
    assert wk.wkv6_bhsk.launches == 1
    want_o, want_s = wk.wkv6_bhsk(r, k, v, lw, u)
    torch.testing.assert_close(got_o.cpu(), want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s.cpu(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,s,dk,regime", [
    (1, 3, 64, 64, "model"),           # one chunk
    (1, 4, 64 * 37, 64, "tests"),      # two full groups and a short one
    (1, 2, 64 * 37, 32, "model"),
    (1, 40, 8192, 64, "model"),        # rwkv6-3b's heads, 128 chunks
])
def test_k7_two_level_scan_matches_plain_across_groups(card, b, h, s, dk,
                                                       regime):
    """K7 (groups of GROUP_CHUNKS chunks, the scan over the groups)
    against its plain version on the card, out and final state within
    1e-4, at one chunk, at a chunk count that is no multiple of the
    group size, and at rwkv6-3b's 40 heads."""
    from repro_torch.kernels.wkv6 import kernel as wk
    x = [t.to(card) for t in _wkv(b, h, s, dk, seed=s + dk, regime=regime)[:5]]
    wk.reset_launches()
    got_o, got_s = wk.wkv6_bhsk(*x)
    assert wk.wkv6_bhsk.launches == 1
    want_o, want_s = wk.wkv6_plain(*x, chunk=wk.CHUNK)
    torch.testing.assert_close(got_o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


def test_k7_back_to_back_calls_of_different_shapes(card):
    """Two K7 calls of different shapes and group counts, queued without
    a sync between them, both equal their plain versions: no scratch or
    state of one call leaks into the other."""
    from repro_torch.kernels.wkv6 import kernel as wk
    xa = [t.to(card) for t in _wkv(1, 8, 64 * 40, 64, seed=1)[:5]]
    xb = [t.to(card) for t in _wkv(2, 3, 64 * 5, 32, seed=2, regime="model")[:5]]
    got = [wk.wkv6_bhsk(*xa), wk.wkv6_bhsk(*xb)]
    for x, (go, gs) in zip((xa, xb), got):
        wo, ws = wk.wkv6_plain(*x, chunk=wk.CHUNK)
        torch.testing.assert_close(go, wo, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-4)


def test_k7_entry_point_with_padding_and_state0(card):
    """The public (B, S, H, K) entry point at S = 100 (padded to 128)
    with a state0 folded in: one K7 launch, equal to the CPU path."""
    from repro_torch.kernels.wkv6 import kernel as wk, ops as wo
    r, k, v, lw, u, s0 = _wkv(1, 4, 100, 32, seed=9)
    args = [t.transpose(1, 2) for t in (r, k, v, lw)] + [u]
    wk.reset_launches()
    got_o, got_s = wo.wkv6(*(t.to(card) for t in args), state0=s0.to(card))
    assert wk.wkv6_bhsk.launches == 1
    want_o, want_s = wo.wkv6(*args, state0=s0)
    torch.testing.assert_close(got_o.cpu(), want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s.cpu(), want_s, rtol=1e-4, atol=1e-4)


def test_k7_refuses_bad_inputs_and_a_refused_launch_raises(card):
    from repro_torch.kernels.wkv6 import kernel as wk, ops as wo
    r, k, v, lw, u, _ = (t.to(card) for t in _wkv(1, 2, 64, 32, seed=1))
    with pytest.raises(ValueError, match="different devices"):
        wk.wkv6_bhsk(r, k.cpu(), v, lw, u)
    with pytest.raises(TypeError, match="float32"):
        wk.wkv6_bhsk(r.half(), k.half(), v.half(), lw.half(), u.half())
    with pytest.raises(ValueError, match="head_dim"):
        big = [torch.zeros((1, 1, 64, 128), device=card) for _ in range(4)]
        wk.wkv6_bhsk(*big, torch.zeros((1, 128), device=card))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wk.wkv6_bhsk(*(t[:, :, :48] for t in (r, k, v, lw)), u)
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6_bhsk(r.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                     lw, u)
    # gridDim.z = B above 65,535: the launch is refused and raises
    z = [torch.zeros((70_000, 1, 64, 32), device=card) for _ in range(4)]
    with pytest.raises(RuntimeError, match="launch failed"):
        wk.wkv6_bhsk(*z, torch.zeros((1, 32), device=card))
    del z
    # no backward on the card either
    ts = [t.transpose(1, 2).detach().requires_grad_(True)
          for t in (r, k, v, lw)]
    with pytest.raises(NotImplementedError, match="forward-only"):
        wo.wkv6(*ts, u)[0].sum().backward()


def test_rwkv_prefill_on_the_card_runs_k7_and_matches_the_cpu(card):
    """Reduced rwkv6-3b: the prefill launches K7 once a layer and equals
    the CPU's plain chunked scan within 1e-5 (the model tests'
    tolerance); a train step's loss and gradients on the card run the
    chunked scan (no K7 launch) and equal the CPU's within 1e-5."""
    from repro_torch import configs
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.train import steps
    mc = configs.get_config("rwkv6-3b").reduced()
    params = tts.init(mc, tts.generator(5))
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, mc.vocab, size=(2, 300)).astype(np.int32))
    step = steps.make_prefill_step(mc, scan_layers=True,
                                   logits_positions="last")
    want = step(params, {"tokens": tok})
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    wk.reset_launches()
    got = step(gparams, {"tokens": tok.to(card)})
    assert wk.wkv6_bhsk.launches == mc.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
    batch = {"tokens": tok[:, :32], "labels": tok[:, 1:33]}
    want_l, want_g = steps.value_and_grad(loss, params, batch)
    wk.reset_launches()
    got_l, got_g = steps.value_and_grad(
        loss, gparams, {k: t.to(card) for k, t in batch.items()})
    assert wk.wkv6_bhsk.launches == 0
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for g, w in zip(pytree.tree_leaves(got_g), pytree.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


CLUSTER_CASES = [("sync_ps", {}, None), ("async_ps", {}, None),
                 ("local_sgd", {"period_h": 2}, None), ("dsgd", {}, None),
                 ("dcd", {}, None), ("ecd", {}, None), ("laq", {}, None),
                 ("local_sgd", {"period_h": 2}, "crash"),
                 ("sync_ps", {"aggregator": "trimmed_mean"}, "byzantine")]


@pytest.mark.parametrize("name, kw, fault", CLUSTER_CASES)
def test_cluster_replay_on_the_card_matches_the_cpu(card, name, kw, fault):
    """A reduced replay of each protocol (the quadratic, 4 workers, the
    rq4 wire) on the card equals the CPU's within 1e-5, and launches K1
    and K4 (the tail bucket only) once per codec call the trace charges:
    every sync-PS gradient, every async or LAQ update, the present
    workers' steps and one checkpoint pull per rejoin; ecd's sign1 wire
    launches none."""
    import dataclasses
    from repro_torch import cluster
    from repro_torch.cluster import execute
    from repro_torch.core import parallel
    n = 4
    spec = cluster.ClusterSpec(
        n_workers=n, t_compute=1.0,
        multipliers=cluster.straggler_multipliers(n, factor=4.0),
        t_lat=1e-2, t_tr=2e-3, size_mb=1.0, codec="rq4")
    plan = {None: None,
            "crash": cluster.crash_restart(n, worker=1, t_down=2.0,
                                           t_up=6.0),
            "byzantine": cluster.byzantine_workers(n, f=1)}[fault]
    proto = cluster.make_protocol(name, **kw)
    tr = (proto.schedule(spec, horizon=12.0, plan=plan)
          if name == "async_ps" else proto.schedule(spec, rounds=3,
                                                    plan=plan))
    prob = parallel.Quadratic.make(prng.PRNGKey(0), d=32, n_workers=n,
                                   device="cpu")
    cpu = execute.problem_workload(prob)
    gpu = execute.problem_workload(dataclasses.replace(
        prob, a=prob.a.to(card), b=prob.b.to(card)))
    kernel.reset_launches()
    got = cluster.replay(tr, gpu, lr=0.1)
    counts = kernel.launch_counts()
    want = cluster.replay(tr, cpu, lr=0.1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    present = tr.extra_or("present") or [range(n)] * 3
    rejoins = sum(len(r) for r in tr.extra_or("rejoiners", ()))
    calls = {"sync_ps": 3 * n, "async_ps": tr.n_updates,
             "laq": tr.n_updates, "dsgd": 3 * n, "dcd": 3 * n, "ecd": 0,
             "local_sgd": 2 * sum(len(p) for p in present) + rejoins}[name]
    assert counts["minmax_bucketed"] == calls
    assert counts["qdq_bucketed"] == calls
    if fault == "crash":
        assert rejoins >= 1


def test_checked_decode_on_the_card_is_k3_and_refuses_a_flipped_bit(card):
    from repro_torch.core import compression
    x = _data(3 * 4096 + 77, seed=4).to(card)
    cdc = compression.codec("rq4")
    layout = compression.FlatLayout.from_tree(x)
    packed, crc = compression.frame(cdc.flat_encode(x, prng.PRNGKey(2),
                                                    layout,
                                                    bucket_elems=4096))
    before = kernel.decode_packed.launches
    got = compression.checked_decode(cdc, packed, crc)
    assert kernel.decode_packed.launches - before == 2
    assert _same_bits(got, cdc.flat_decode(packed))
    with pytest.raises(compression.WireCorruptionError):
        compression.checked_decode(cdc, compression.flip_bit(packed, 9), crc)


FAMILY_ARCHS = ("recurrentgemma-9b", "deepseek-v2-lite-16b", "qwen2.5-14b",
                "command-r-35b", "grok-1-314b")


def _reduced_family(arch):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.common import MLAConfig
    cfg = configs.get_config(arch)
    if arch == "recurrentgemma-9b":
        return dataclasses.replace(cfg.reduced(n_layers=5), block_pattern=(
            "rglru", "rglru", "local_attn", "rglru", "rglru"))
    if arch == "deepseek-v2-lite-16b":      # MLA at head dims K6 builds
        return dataclasses.replace(cfg.reduced(n_layers=3), mla=MLAConfig(
            kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg.reduced()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_train_step_on_the_card_match_the_cpu(card,
                                                                 arch):
    """The hybrid and MoE families reduced: the flash prefill launches
    K6 once per attention or MLA layer (none for RG-LRU) and equals the
    CPU's plain version within 1e-5; a train step's loss (with the MoE
    aux) and gradients equal the CPU's within 1e-5."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.train import steps
    mc = _reduced_family(arch)
    params = tts.init(mc, tts.generator(5))
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, mc.vocab, size=(2, 300)).astype(np.int32))
    step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    want = step(params, {"tokens": tok})
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    fk.reset_launches()
    got = step(gparams, {"tokens": tok.to(card)})
    assert fk.flash_attention_bhsd.launches == sum(
        k in ("attn", "local_attn", "mla") for k in mc.block_pattern)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
    batch = {"tokens": tok[:, :32], "labels": tok[:, 1:33]}
    want_l, want_g = steps.value_and_grad(loss, params, batch)
    got_l, got_g = steps.value_and_grad(
        loss, gparams, {k: t.to(card) for k, t in batch.items()})
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for g, w in zip(pytree.tree_leaves(got_g), pytree.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "deepseek-v2-lite-16b"])
def test_family_decode_on_the_card_matches_the_cpu(card, arch):
    """A 12-token bulk prefill (the decode loop) of the reduced model on
    fp32 caches, then one step with the engine's slot grouping: logits
    and every state leaf equal the CPU's within 1e-5."""
    from repro_torch.train import steps
    mc = _reduced_family(arch)
    params = tts.init(mc, tts.generator(7))
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, mc.vocab, size=(3, 12)).astype(np.int32))
    bulk = steps.make_bulk_prefill(mc, scan_layers=True)
    f32 = dict(dtype=torch.float32)
    lc, sc = bulk(params, tts.init_decode_state(params, mc, 3, 16, **f32),
                  tok)
    lg, sg = bulk(gparams, tts.init_decode_state(gparams, mc, 3, 16, **f32),
                  tok.to(card))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for a, b in zip(pytree.tree_leaves(sg), pytree.tree_leaves(sc)):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    step = steps.make_serve_step(mc, scan_layers=True,
                                  moe_rows=True)
    nxt = tok[:, :1]
    lc, _ = step(params, sc, {"tokens": nxt})
    lg, _ = step(gparams, sg, {"tokens": nxt.to(card)})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)


# the per-leaf tier: K2-K4 launched on leaf messages, the exchanges at
# flat=False, and the unrolled decode on the int8 KV cache

LEAF_EMBED = 25_165_824          # repro-100m's embedding leaf (vocab x d)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_leaf_kernels_at_the_embedding_leaf_bit_equal_to_plain(card, bits):
    """K4, K2 and K3 as one per-leaf launch each over two workers'
    25,165,824-element leaves (the largest leaf of repro-100m), against
    their plain versions on the same card tensors, bit for bit; each
    counted once on its own per-leaf counter."""
    from repro_torch.kernels.quant import ref
    g = torch.Generator(device=card).manual_seed(bits)
    x = torch.randn((2, LEAF_EMBED), generator=g, device=card) * 0.02
    keys = [prng.PRNGKey(1), prng.PRNGKey(2)]
    x4, params = ops._leaf_rows(x, keys, bits=bits)
    kernel.reset_launches()
    q = kernel.leaf_qdq(x4, keys, params, bits=bits)
    pay = kernel.leaf_encode_packed(x4, keys, params, bits=bits)
    dec = kernel.leaf_decode_packed(pay, params, bits=bits)
    assert (kernel.leaf_qdq.launches, kernel.leaf_encode_packed.launches,
            kernel.leaf_decode_packed.launches) == (1, 1, 1)
    assert kernel.qdq_bucketed.launches == kernel.encode_packed.launches \
        == kernel.decode_packed.launches == 0
    lo, scale = params[:, 0], params[:, 1]
    assert _same_bits(q, ref.qdq_keyed(x4, keys, lo, scale, bits=bits))
    assert torch.equal(pay, ref.encode_packed_keyed(x4, keys, lo, scale,
                                                    bits=bits))
    assert _same_bits(dec, ref.decode_packed_bucketed(pay, lo, scale,
                                                      bits=bits))
    assert _same_bits(dec, q)


@pytest.mark.parametrize("name,compressor", [("csgd_ring", "rq4"),
                                             ("csgd_ps", "rq8"),
                                             ("ecsgd", "rq4")])
def test_per_leaf_exchange_on_the_card_matches_the_cpu(card, name,
                                                       compressor):
    """The flat=False exchanges over 4 stacked workers: the card's
    update (and ECSGD's error trees) equal the CPU's bit for bit (the
    ring) or within 1e-6 (a pmean); the launches a step are the stated
    arithmetic over L leaves: the ring 4L K2 and 4L K3 (N (1 + (N-1))
    encodes / decodes, each one launch over the N workers), the PS and
    ECSGD 2L K4."""
    from repro_torch.core import communicators
    rng = np.random.default_rng(1)
    g = {"a": torch.from_numpy(rng.normal(size=(4, 30_000)).astype(
        np.float32)), "b": [torch.from_numpy(rng.normal(size=(4, 7, 3))
                                             .astype(np.float32))]}
    ex = communicators.make_exchange(name, compressor=compressor,
                                     flat=False)
    gg = pytree.tree_map(lambda t: t.to(card), g)
    kernel.reset_launches()
    got, gst = ex(gg, ex.init(gg), prng.PRNGKey(3))
    leaves = 2
    counts = {k: v for k, v in kernel.launch_counts().items() if v}
    if name == "csgd_ring":
        assert counts == {"leaf_encode_packed": 4 * leaves,
                          "leaf_decode_packed": 4 * leaves}
    else:
        assert counts == {"leaf_qdq": 2 * leaves}
    want, wst = ex(g, ex.init(g), prng.PRNGKey(3))
    for a, b in zip(pytree.tree_leaves((got, gst)),
                    pytree.tree_leaves((want, wst))):
        if name == "csgd_ring":
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)


def test_int8_cache_decode_on_the_card_matches_the_cpu(card):
    """The reduced qwen1.5-0.5b unrolled: a 12-token bulk prefill and 4
    steps on the int8 KV cache, card against CPU: logits within 2e-3 of
    their scale (an int8 code at a rounding half may flip by one where
    the card's float32 sums differ by an ulp, as against JAX in
    tests/test_torch_decode.py), codes off by at most one."""
    from repro_torch import configs
    from repro_torch.models import transformer as tt
    from repro_torch.train import steps
    mc = configs.get_config("qwen1.5-0.5b").reduced()
    params = tt.init(mc, tts.generator(3))
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, mc.vocab, size=(2, 16)).astype(np.int32))
    mk = lambda p: tt.init_decode_state(  # noqa: E731
        p, mc, 2, 20, dtype=torch.float32, quantize_kv=True)
    bulk, step = steps.make_bulk_prefill(mc), steps.make_serve_step(mc)
    lc, sc = bulk(params, mk(params), tok[:, :12])
    lg, sg = bulk(gparams, mk(gparams), tok[:, :12].to(card))
    pairs = [(lg, lc)]
    for i in range(12, 16):
        lc, sc = step(params, sc, {"tokens": tok[:, i:i + 1]})
        lg, sg = step(gparams, sg, {"tokens": tok[:, i:i + 1].to(card)})
        pairs.append((lg, lc))
    for g_, c_ in pairs:
        assert float((g_.cpu() - c_).abs().max()) <= \
            2e-3 * float(c_.abs().max())
    for a, b in zip(sg["layers"], sc["layers"]):
        assert a["k"].dtype == torch.int8
        for name in ("k", "v"):
            d = (a[name].cpu().int() - b[name].int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) \
                <= 1e-3


# the embedding frontends: M-RoPE on stub embeddings (qwen2-vl-72b) and
# the encoder-decoder (seamless-m4t-large-v2), reduced

FRONTEND_ARCHS = ("qwen2-vl-72b", "seamless-m4t-large-v2")


def _frontend_batch(mc, b, s, seed):
    """Stub embeddings, a text / patch-grid / text position grid for an
    mrope model, source frames for an enc-dec one."""
    rng = np.random.default_rng(seed)
    batch = {"embeddings": torch.from_numpy(
        (rng.normal(size=(b, s, mc.d_model)) * 0.5).astype(np.float32))}
    if mc.rope_variant == "mrope":
        text, rows, cols = s // 8, 4, s // 8
        ids = [np.arange(text)] * 3
        grid = [np.full(rows * cols, text),
                text + np.repeat(np.arange(rows), cols),
                text + np.tile(np.arange(cols), rows)]
        tail = text + max(rows, cols) + np.arange(s - text - rows * cols)
        p3 = np.stack([np.concatenate([a, g, tail])
                       for a, g in zip(ids, grid)]).astype(np.int32)
        batch["positions3"] = torch.from_numpy(p3)[None].expand(b, 3, s)
    if mc.is_encdec:
        batch["src_embeddings"] = torch.from_numpy(
            (rng.normal(size=(b, s // 2, mc.d_model)) * 0.5).astype(
                np.float32))
    return batch


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_prefill_and_train_step_on_the_card_match_the_cpu(card,
                                                                   arch):
    """The reduced model on stub embeddings: the flash prefill launches
    K6 once a decoder layer (never in the encoder or the cross
    attention) and equals the CPU's plain version within 1e-5; a train
    step's loss and gradients equal the CPU's within 1e-5."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.train import steps
    mc = configs.get_config(arch).reduced()
    params = tts.init(mc, tts.generator(5))
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    batch = _frontend_batch(mc, 2, 256, seed=6)
    gbatch = {k: v.to(card) for k, v in batch.items()}
    step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    want = step(params, batch)
    fk.reset_launches()
    got = step(gparams, gbatch)
    assert fk.flash_attention_bhsd.launches == mc.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    if mc.is_encdec:
        tts.encode(gparams, mc, gbatch["src_embeddings"])
        assert fk.flash_attention_bhsd.launches == mc.n_layers
    labels = torch.from_numpy(np.random.default_rng(7).integers(
        0, mc.vocab, size=(2, 256)).astype(np.int32))
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
    want_l, want_g = steps.value_and_grad(loss, params,
                                          {**batch, "labels": labels})
    got_l, got_g = steps.value_and_grad(
        loss, gparams, {**gbatch, "labels": labels.to(card)})
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for g, w in zip(pytree.tree_leaves(got_g), pytree.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_decode_on_the_card_matches_the_cpu(card, arch, cache):
    """8 decode steps of the reduced model (stub embeddings at text
    positions; tokens over the encoder memory), card against CPU: the
    fp32 cache within 1e-5, the bf16 and int8 caches within 2e-3 of the
    logits' scale (a K/V value at a rounding half may land a step apart
    where the float32 sums differ by an ulp)."""
    from repro_torch import configs
    from repro_torch.train import steps
    mc = configs.get_config(arch).reduced()
    params = tts.init(mc, tts.generator(9))
    gparams = pytree.tree_map(lambda t: t.to(card), params)
    batch = _frontend_batch(mc, 2, 16, seed=10)
    tok = torch.from_numpy(np.random.default_rng(11).integers(
        0, mc.vocab, size=(2, 8)).astype(np.int32))
    step = steps.make_serve_step(mc, scan_layers=True)

    def run(p, dev):
        kw = {}
        if mc.is_encdec:
            kw["memory"] = tts.encode(p, mc, batch["src_embeddings"].to(dev))
        st = tts.init_decode_state(
            p, mc, 2, 10, quantize_kv=cache == "int8",
            dtype=torch.bfloat16 if cache == "bf16" else torch.float32,
            **kw)
        outs = []
        for i in range(8):
            inp = ({"tokens": tok[:, i:i + 1].to(dev)} if mc.is_encdec else
                   {"embeddings": batch["embeddings"][:, i:i + 1].to(dev)})
            logits, st = step(p, st, inp)
            outs.append(logits.cpu())
        return outs

    for g, c in zip(run(gparams, card), run(params, "cpu")):
        if cache == "fp32":
            torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5)
        else:
            assert float((g - c).abs().max()) <= 2e-3 * float(c.abs().max())


def test_host_mesh_builds_on_the_card(card):
    """make_host_mesh() over the one card, on a world-1 NCCL group."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        hm = mesh_lib.make_host_mesh()
        assert tuple(hm.shape) == (1,)
        assert hm.mesh_dim_names == ("data",)
        assert hm.device_type == "cuda"
    finally:
        dist.destroy_process_group()


def test_world_one_nccl_launcher_is_the_one_card_launcher(card, tmp_path):
    """``launch.train.main`` on a world-1 NCCL group made from torchrun's
    variables (reduced repro-100m, rq4 + EF, 3 steps, K1 and K4 on the
    card) ends with the one-card launcher's state, bit for bit, and
    destroys the group it made."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "32",
            "--compression", "rq4", "--error-feedback"]
    kernel.reset_launches()
    one = train.main(argv)
    assert kernel.qdq_bucketed.launches == 3    # one bucket: one K4 a step
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ranked = train.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    assert not dist.is_initialized()
    assert kernel.qdq_bucketed.launches == 6
    for a, b in zip(pytree.tree_leaves(one), pytree.tree_leaves(ranked)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


def test_dry_run_estimate_of_a_train_step_holds_on_the_card(card, tmp_path):
    """The one-device dry run (a subprocess: its fake process group is
    global to a process) of full-width repro-100m training on 1 x 1024,
    against the same step on the card: argument bytes equal to the
    storage placed and to the bytes requested of the allocator (its
    blocks at most 1 MiB a tensor more), the
    same dot FLOPs, temp within 10 % of the card's peak beyond what is
    live."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import dryrun
    from repro_torch.models.common import InputShape
    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "estimate.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--combo",
         "repro-100m:train_4k", "--mesh", "1x1", "--batch", "1", "--seq",
         "1024", "--out", str(out)], cwd=root, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads(out.read_text().splitlines()[0])
    got = dryrun.run_on_card("repro-100m", "train_4k",
                             shape=InputShape("train_4k", 1024, 1, "train"))
    assert rec["argument_size_in_bytes"] == got["placed_bytes"] \
        == got["requested_growth"]
    # 512-byte rounding; a large block is not split when the rest of its
    # segment would be 1 MiB or less
    assert 0 <= got["allocated_growth"] - got["placed_bytes"] \
        <= (1 << 20) * got["n_tensors"]
    assert rec["dot_flops"] == got["dot_flops"]
    peak = got["peak_beyond_live"]
    assert abs(rec["temp_size_in_bytes"] - peak) <= 0.10 * peak

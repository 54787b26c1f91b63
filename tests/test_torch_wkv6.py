"""repro_torch's WKV6 module against repro's: the plain version (the
path of CPU tensors) of ``wkv6_bhsk`` against the Pallas kernel in
interpret mode, the public ``ops.wkv6`` (padding, state0 fold-in)
against JAX's ``ops.wkv6`` and the token-by-token recurrence, the
chunked oracle against JAX's, and the forward-only contract. Inputs
are made with numpy from a seed and fed to both, at the JAX tests'
shapes and decays (log_w = -exp(N(0, 0.5) - 2)).

Tolerance rtol = atol = 1e-4: the JAX package's kernel-vs-recurrence
tolerance (the chunked form sums in another order than the recurrence
and carries exp(-cum) factors up to ~e^10). Padding is checked bit for
bit: a padded step (k = 0, log_w = 0) adds exactly nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import kernel as jwk
from repro.kernels.wkv6 import ops as jwo
from repro.kernels.wkv6 import ref as jwr
from repro.models import rwkv as jrwkv
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import ops as wo
from repro_torch.kernels.wkv6 import ref as wr

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _first_exp_done():
    """PyTorch 2.13's CPU build (AVX512) can compute the first
    multi-threaded ``torch.exp`` of a process with one thread's share of the elements
    off by up to 1.5e-4 relative (the next call is exact, and a warm-up
    with another op does not help): one exp over 2**16 elements before
    the comparisons keeps that library fault out of them."""
    torch.exp(torch.zeros(1 << 16))


SHAPES = [(2, 128, 2, 64), (1, 100, 4, 32), (2, 192, 1, 64)]   # (B,S,H,K)


def _inputs(b, s, h, dk, seed, lw_scale=0.5, lw_shift=-2.0):
    """r, k, v, log_w (B, S, H, K), u (H, K), state0 (B, H, K, K)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, dk)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, s, h, dk)) * lw_scale + lw_shift
                 ).astype(np.float32)
    u = (rng.normal(size=(h, dk)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(b, h, dk, dk)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _bhsk(*arrs):
    return [np.ascontiguousarray(np.moveaxis(a, 2, 1)) for a in arrs]


@pytest.mark.parametrize("with_state0", [False, True],
                         ids=["zero_state", "state0"])
@pytest.mark.parametrize("b,s,h,dk", SHAPES)
def test_ops_matches_jax_and_the_recurrence(b, s, h, dk, with_state0):
    r, k, v, lw, u, s0 = _inputs(b, s, h, dk, seed=s * h)
    s0 = s0 if with_state0 else None
    kw = {} if s0 is None else {"state0": s0}
    wk.reset_launches()
    got_o, got_s = wo.wkv6(*_t(r, k, v, lw, u),
                           **{n: torch.from_numpy(a) for n, a in kw.items()})
    assert wk.wkv6_bhsk.launches == 0        # CPU: plain version
    assert tuple(got_o.shape) == (b, s, h, dk)
    assert tuple(got_s.shape) == (b, h, dk, dk)
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    want_o, want_s = jwo.wkv6(*jargs, **jkw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    step_o, step_s = jwr.wkv6_stepwise(*jargs, **jkw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(step_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(step_s), **TOL)
    # the port's own recurrence agrees with JAX's
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    po, ps = wr.wkv6_stepwise(*_t(r, k, v, lw, u), **tkw)
    np.testing.assert_allclose(po.numpy(), np.asarray(step_o), **TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(step_s), **TOL)


@pytest.mark.parametrize("b,s,h,dk", [(2, 128, 2, 64), (1, 128, 4, 32),
                                      (2, 192, 1, 64)])
def test_plain_bhsk_matches_the_pallas_kernel(b, s, h, dk):
    """The plain version of K7 on (B, H, S, K) against the Pallas kernel
    run in interpret mode, as the JAX tests run it on the CPU."""
    r, k, v, lw, u, _ = _inputs(b, s, h, dk, seed=7 * s + h)
    r, k, v, lw = _bhsk(r, k, v, lw)
    want_o, want_s = jwk.wkv6_bhsk(*(jnp.asarray(a) for a in
                                     (r, k, v, lw, u)),
                                   chunk=64, interpret=True)
    wk.reset_launches()
    got_o, got_s = wk.wkv6_bhsk(*_t(r, k, v, lw, u), chunk=64)
    assert wk.wkv6_bhsk.launches == 0
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("chunk", [32, 64])
def test_chunked_oracle_matches_jax(chunk):
    """``ref.wkv6`` (the model's ``wkv_chunked``) against JAX's at the
    JAX oracle test's decays (log_w = -exp(N(0, 0.3) - 2.5))."""
    r, k, v, lw, u, _ = _inputs(1, 96, 2, 32, seed=11, lw_scale=0.3,
                                lw_shift=-2.5)
    want_o, want_s = jwr.wkv6(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                              chunk=chunk)
    got_o, got_s = wr.wkv6(*_t(r, k, v, lw, u), chunk=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_padding_is_the_identity_on_the_state():
    """A padded step (k = 0, log_w = 0) leaves the state and the earlier
    outputs exactly as they were, whatever r and v hold there: ops pads
    S = 100 to 128, and filling the pad's r and v with noise changes no
    bit of the state or of out[:100]."""
    b, s, h, dk = 1, 100, 2, 64
    r, k, v, lw, u, _ = _inputs(b, s, h, dk, seed=3)
    r, k, v, lw = (torch.from_numpy(a) for a in _bhsk(r, k, v, lw))
    pad = 28
    noise = torch.from_numpy(np.random.default_rng(4).normal(
        size=(b, h, pad, dk)).astype(np.float32))
    zeros = torch.zeros((b, h, pad, dk))
    u = torch.from_numpy(u)
    o_zero, s_zero = wk.wkv6_bhsk(*(torch.cat([t, zeros], 2)
                                    for t in (r, k, v, lw)), u)
    o_noise, s_noise = wk.wkv6_bhsk(
        torch.cat([r, noise], 2), torch.cat([k, zeros], 2),
        torch.cat([v, noise * 3], 2), torch.cat([lw, zeros], 2), u)
    assert torch.equal(s_zero, s_noise)
    assert torch.equal(o_zero[:, :, :s], o_noise[:, :, :s])
    # and the state is the recurrence's over the 100 real steps
    _, s_step = wr.wkv6_stepwise(*(t.transpose(1, 2) for t in (r, k, v, lw)),
                                 u)
    np.testing.assert_allclose(s_zero.numpy(), s_step.numpy(), **TOL)


def test_backward_raises():
    """Forward-only, as the Pallas kernel: a backward through ops.wkv6
    raises on the CPU too (the model's CPU training path uses
    ``wkv_chunked`` instead)."""
    r, k, v, lw, u, _ = _inputs(1, 64, 1, 32, seed=5)
    ts = [t.requires_grad_(True) for t in _t(r, k, v, lw, u)]
    out, _ = wo.wkv6(*ts)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


def test_wrapper_refuses_bad_inputs_on_the_cpu():
    r, k, v, lw, u, _ = _inputs(1, 64, 2, 32, seed=6)
    r, k, v, lw = _t(*_bhsk(r, k, v, lw))
    u = torch.from_numpy(u)
    with pytest.raises(TypeError, match="float32"):
        wk.wkv6_bhsk(r.double(), k, v, lw, u)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wk.wkv6_bhsk(r[:, :, :60], k[:, :, :60], v[:, :, :60],
                     lw[:, :, :60], u)
    with pytest.raises(ValueError, match="shape"):
        wk.wkv6_bhsk(r, k[:, :1], v, lw, u)
    with pytest.raises(ValueError, match=r"is not \(H, K\)"):
        wk.wkv6_bhsk(r, k, v, lw, u[:1])


# ---- K7's arithmetic, emulated: the two-level chunk scan on 3xTF32 ----

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` and K7's split of the
    big part: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low bits dropped: what the tensor core reads of a
    TF32 operand that was not rounded (K7's small part)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a, b, mode):
    """a @ b as the tensor cores compute it in each mode, fp32
    accumulation: "3xtf32" is K7's split (big rounded, small truncated,
    the small cross terms first), "tf32" a single TF32 product."""
    if mode == "fp32":
        return a @ b
    ab, bb = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ab @ bb
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _warp_cumsum(x: torch.Tensor) -> torch.Tensor:
    """K7's cumsum down a chunk (dim -2, 64 steps) in its order: lane l
    holds steps l and l + 32; a Kogge-Stone scan over the lanes for each
    half (x_l = x_{l-d} + x_l, d = 1, 2, 4, 8, 16), then the first
    half's total added to the second half."""
    def scan(h):
        for d in (1, 2, 4, 8, 16):
            h = torch.cat([h[..., :d, :], h[..., :-d, :] + h[..., d:, :]],
                          dim=-2)
        return h
    a, b = scan(x[..., :32, :]), scan(x[..., 32:, :])
    return torch.cat([a, a[..., 31:32, :] + b], dim=-2)


def _k7_emulated(r, k, v, lw, u, *, group: int, mode: str):
    """K7's two-level scan on (B, H, S, K) tensors, S a multiple of 64:
    (a) each group of ``group`` chunks runs the state recurrence from
    zero (local state L_g, decay D_g = the product of its chunks'
    exp(total), in order); (b) the elementwise scan over the groups,
    S_{g+1} = D_g * S_g + L_g from 0, gives each group's entry state and
    the final state; (c) each group's outputs from its entry state.
    Every product is computed in ``mode`` into a fresh accumulator; the
    cumsum in the kernel's warp order; the bonus as the kernel sums it
    (each of W = K / 4 warps over its 4 columns in order; lane t of a
    quad sums the partials of warps t, t + 4, ... in order, and the quad
    adds its four sums pairwise)."""
    b, h, s, dk = r.shape
    c = 64
    nc = s // c
    ch = [t.reshape(b, h, nc, c, dk) for t in (r, k, v, lw)]
    rc, kc, vc, lwc = ch
    cum = _warp_cumsum(lwc)
    total = cum[..., -1, :]                               # (B, H, nc, K)
    q_in = rc * torch.exp(cum - lwc)
    kd = kc * torch.exp(-cum)
    k_carry = kc * torch.exp(total[..., None, :] - cum)
    e = torch.exp(total)
    n_warps = dk // 4
    terms = (rc * u[None, :, None, None, :] * kc).reshape(b, h, nc, c,
                                                           n_warps, 4)
    part = terms[..., 0]
    for j in range(1, 4):
        part = part + terms[..., j]
    quad = []
    for lane in range(4):
        acc = part[..., lane]
        for w in range(lane + 4, n_warps, 4):
            acc = acc + part[..., w]
        quad.append(acc)
    bonus = (quad[0] + quad[1]) + (quad[2] + quad[3])
    strict = torch.tril(torch.ones((c, c), dtype=torch.bool), diagonal=-1)
    att = torch.where(strict, _product(q_in, kd.transpose(-1, -2), mode),
                      0.0)
    new = _product(k_carry.transpose(-1, -2), vc, mode)   # (.., nc, K, K)
    groups = [range(g0, min(g0 + group, nc)) for g0 in range(0, nc, group)]
    local, decay = [], []
    for chunks in groups:                                 # pass (a)
        st = torch.zeros((b, h, dk, dk))
        d = torch.ones((b, h, dk))
        for i in chunks:
            st = e[:, :, i, :, None] * st + new[:, :, i]
            d = d * e[:, :, i]
        local.append(st)
        decay.append(d)
    entry, cur = [], torch.zeros((b, h, dk, dk))
    for lg, dg in zip(local, decay):                      # pass (b)
        entry.append(cur)
        cur = dg[..., None] * cur + lg
    out = torch.empty((b, h, nc, c, dk))
    for chunks, st in zip(groups, entry):                 # pass (c)
        for i in chunks:
            out[:, :, i] = ((_product(q_in[:, :, i], st, mode)
                             + _product(att[:, :, i], vc[:, :, i], mode))
                            + bonus[:, :, i, :, None] * vc[:, :, i])
            if i != chunks[-1]:
                st = e[:, :, i, :, None] * st + new[:, :, i]
    return out.reshape(b, h, s, dk), cur


def _regime_inputs(b, s, h, dk, seed, regime):
    """The JAX tests' decays ("tests") or rwkv6-3b's own at init
    ("model": log_w = -exp(-6 + 0.3 tanh(N(0, 1))))."""
    r, k, v, lw, u, _ = _inputs(b, s, h, dk, seed)
    if regime == "model":
        lw = -np.exp(-6.0 + 0.3 * np.tanh(np.random.default_rng(
            seed + 1).normal(size=lw.shape))).astype(np.float32)
    return r, k, v, lw, u


def _padded_bhsk(r, k, v, lw):
    """(B, S, H, K) -> (B, H, S', K), S' the chunk multiple: ops.wkv6's
    padding (zeros; k = 0 and log_w = 0 leave the state alone)."""
    pad = (-r.shape[1]) % 64
    return [torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.pad(
        a, ((0, 0), (0, pad), (0, 0), (0, 0))), 2, 1))) for a in
        (r, k, v, lw)]


# (B, S, H, K), group: the JAX tests' shapes (two and three chunks, S =
# 100 padded: groups larger than the sequence, or three chunks in groups
# of two), one chunk, and 11 chunks in groups of 4
TWO_LEVEL_CASES = [((2, 128, 2, 64), 4), ((1, 100, 4, 32), 4),
                   ((2, 192, 1, 64), 2), ((1, 64, 2, 64), 4),
                   ((1, 704, 2, 64), 4)]


@pytest.mark.parametrize("regime", ["tests", "model"])
@pytest.mark.parametrize("shape,group", TWO_LEVEL_CASES,
                         ids=[f"S{c[0][1]}-G{c[1]}" for c in TWO_LEVEL_CASES])
def test_two_level_scan_equals_the_plain_version_and_jax(shape, group,
                                                         regime):
    """K7's two-level chunk scan, emulated in plain fp32 torch (group
    states from zero, the elementwise scan over the groups, outputs from
    the entry states), equals ``wkv6_plain`` and the JAX package's
    ``wkv_chunked`` within 1e-4, out and state."""
    b, s, h, dk = shape
    r, k, v, lw, u = _regime_inputs(b, s, h, dk, seed=s + group, regime=regime)
    x = _padded_bhsk(r, k, v, lw)
    got_o, got_s = _k7_emulated(*x, torch.from_numpy(u), group=group,
                                mode="fp32")
    want_o, want_s = wk.wkv6_plain(*x, torch.from_numpy(u), chunk=64)
    torch.testing.assert_close(got_o, want_o, **TOL)
    torch.testing.assert_close(got_s, want_s, **TOL)
    j_o, j_s = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, lw, u)))
    np.testing.assert_allclose(got_o.transpose(1, 2)[:, :s].numpy(),
                               np.asarray(j_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(j_s), **TOL)


@pytest.mark.parametrize("regime", ["tests", "model"])
@pytest.mark.parametrize("shape,group", [((2, 192, 1, 64), 2),
                                         ((1, 704, 2, 64), 4),
                                         ((1, 128, 4, 32), 8)],
                         ids=["S192-G2", "S704-G4", "S128-K32"])
def test_3xtf32_keeps_k7_within_tolerance_and_one_tf32_pass_does_not(
        shape, group, regime):
    """The tolerance argument for K7's tensor-core route, emulated on the
    CPU: its four products (q_in @ kd^T, q_in @ S, att @ v, k_carry^T @
    v) in 3xTF32, each into a fresh accumulator, with the warp-order
    cumsum and the two-level scan, stay within 1e-4 of the plain
    version, out and state; one TF32 pass does not."""
    b, s, h, dk = shape
    r, k, v, lw, u = _regime_inputs(b, s, h, dk, seed=3 * s + dk,
                                    regime=regime)
    x = _padded_bhsk(r, k, v, lw)
    uu = torch.from_numpy(u)
    want_o, want_s = wk.wkv6_plain(*x, uu, chunk=64)
    got_o, got_s = _k7_emulated(*x, uu, group=group, mode="3xtf32")
    torch.testing.assert_close(got_o, want_o, **TOL)
    torch.testing.assert_close(got_s, want_s, **TOL)
    one_o, one_s = _k7_emulated(*x, uu, group=group, mode="tf32")
    assert not (torch.allclose(one_o, want_o, **TOL)
                and torch.allclose(one_s, want_s, **TOL))


@pytest.mark.cuda
def test_k7_matches_the_plain_version_on_the_card():
    """K7 on the card against the CPU plain version (rtol = atol =
    1e-4); runs only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card: "
                    "python3 chip_smoke.py)")
    r, k, v, lw, u, _ = _inputs(2, 128, 2, 64, seed=8)
    args = _t(*_bhsk(r, k, v, lw), u)
    wk.reset_launches()
    got_o, got_s = wk.wkv6_bhsk(*(t.cuda() for t in args))
    assert wk.wkv6_bhsk.launches == 1
    want_o, want_s = wk.wkv6_bhsk(*args)
    torch.testing.assert_close(got_o.cpu(), want_o, **TOL)
    torch.testing.assert_close(got_s.cpu(), want_s, **TOL)

"""The convergence claims of the JAX package's tests/test_convergence.py
and tests/test_dcd.py, run through the port's algorithm tier
(``repro_torch.core.parallel.run_quadratic`` on the CPU) with the same
methods, step counts, learning rates and thresholds."""
import numpy as np
import torch

from repro_torch.core import mixing, parallel


def run(method, **kw):
    return parallel.run_quadratic(method, device="cpu", **kw)


def final_gnorm(res, k=20):
    return float(res.grad_norms[-k:].mean())


def test_gd_converges_to_stationary_point():
    """Thm 1.1.1: the averaged grad norm -> 0, monotonically."""
    res = run("gd", steps=400, lr=0.5)
    g = res.grad_norms.numpy()
    assert g[-1] < 1e-3 * g[0]
    assert np.all(np.diff(g[10:]) <= 1e-9)


def test_sgd_noise_floor_vs_minibatch():
    """Eq. (1.20): minibatching divides the variance term by B."""
    sgd = run("sgd", steps=600, lr=0.3, batch=1, seed=1)
    mb = run("mbsgd", n_workers=8, steps=600, lr=0.3, batch=1, seed=1)
    assert final_gnorm(mb, k=50) < 0.5 * final_gnorm(sgd, k=50)


def test_csgd_adds_variance_but_converges():
    """Eq. (3.6): CSGD converges; coarser quantization is noisier."""
    base = run("mbsgd", n_workers=4, steps=300, lr=0.05)
    c8 = run("csgd_ps", n_workers=4, steps=300, lr=0.05,
             exchange_kw={"compressor": "rq8"})
    c2 = run("csgd_ps", n_workers=4, steps=300, lr=0.05,
             exchange_kw={"compressor": "rq2"})
    assert final_gnorm(c8) < 5e-2
    assert final_gnorm(c2) < 5e-2
    dev8 = float((c8.losses - base.losses).abs().mean())
    dev2 = float((c2.losses - base.losses).abs().mean())
    assert dev2 > 5.0 * dev8


def test_csgd_ring_partitioned_converges_with_identical_workers():
    """The partitioned ring (rq4, K5's plain version on every hop)
    converges like the PS form, and its verbatim all-gather keeps every
    worker bit-identical: consensus exactly 0 at every step."""
    ring = run("csgd_ring", n_workers=4, steps=150, lr=0.05,
               exchange_kw={"compressor": "rq4"})
    assert final_gnorm(ring) < 5e-2
    assert float(ring.losses[-1]) < 0.9 * float(ring.losses[0])
    assert ring.consensus.abs().max().item() == 0.0


def test_ecsgd_beats_naive_biased_compression():
    """Section 3.3: with sign1, plain CSGD stalls while EC-SGD tracks
    mb-SGD."""
    ec = run("ecsgd", n_workers=4, steps=400, lr=0.05,
             exchange_kw={"compressor": "sign1"})
    naive = run("csgd_ps", n_workers=4, steps=400, lr=0.05,
                exchange_kw={"compressor": "sign1"})
    ref = run("mbsgd", n_workers=4, steps=400, lr=0.05)
    assert final_gnorm(ec) < 3 * final_gnorm(ref) + 1e-3
    assert final_gnorm(ec) < 0.65 * final_gnorm(naive)


def test_asgd_staleness_slows_but_converges():
    """Thm 4.2.2: bounded staleness keeps convergence; larger tau is not
    faster."""
    t0 = run("mbsgd", n_workers=4, steps=400, lr=0.05)
    t4 = run("asgd", n_workers=4, steps=400, lr=0.05,
             exchange_kw={"tau": 4})
    t16 = run("asgd", n_workers=4, steps=400, lr=0.05,
              exchange_kw={"tau": 16})
    assert final_gnorm(t4) < 5e-2
    assert final_gnorm(t16) >= final_gnorm(t4) - 1e-4
    assert final_gnorm(t4) >= final_gnorm(t0) - 1e-4


def test_asgd_too_large_staleness_with_large_lr_unstable():
    """The tau * lr * L <= 1/2 condition (Eq. 4.8) bites."""
    stable = run("mbsgd", n_workers=4, steps=200, lr=20.0)
    wild = run("asgd", n_workers=4, steps=200, lr=20.0,
               exchange_kw={"tau": 16})
    w = final_gnorm(wild)
    assert (not np.isfinite(w)) or w > 10 * final_gnorm(stable)


def test_dsgd_consensus_and_convergence():
    """Thm 5.2.6 + Lemma 5.2.4: DSGD converges and reaches consensus."""
    res = run("dsgd", n_workers=8, steps=500, lr=0.05, heterogeneity=0.3)
    assert final_gnorm(res) < 5e-2
    assert float(res.consensus[-1]) < float(res.consensus[5]) * 10
    assert float(res.consensus[-1]) < 1e-2


def test_dsgd_full_topology_matches_mbsgd():
    """rho = 0 (fully connected) reduces DSGD to mb-SGD."""
    full = run("dsgd", n_workers=4, steps=200, lr=0.05,
               gossip_topology="full")
    ring = run("dsgd", n_workers=4, steps=200, lr=0.05)
    assert float(full.consensus[-1]) < 1e-10
    assert final_gnorm(full) < 5e-2 and final_gnorm(ring) < 5e-2


def test_dsgd_heterogeneity_raises_floor():
    """The varsigma term of Thm 5.2.6: outer variance raises the
    steady-state consensus floor."""
    homo = run("dsgd", n_workers=8, steps=300, lr=0.05, heterogeneity=0.0,
               seed=3)
    hetero = run("dsgd", n_workers=8, steps=300, lr=0.05,
                 heterogeneity=2.0, seed=3)
    assert float(hetero.consensus[-50:].mean()) > \
        3.0 * float(homo.consensus[-50:].mean())
    assert final_gnorm(hetero) < 5e-2 and final_gnorm(homo) < 5e-2


def test_dcd_identity_codec_tracks_dsgd():
    """With the identity codec DCD is plain D-PSGD."""
    w = mixing.ring(8)
    dsgd = run("dsgd", n_workers=8, steps=60, lr=0.05, gossip_w=w)
    dcd = run("dcd", n_workers=8, steps=60, lr=0.05, gossip_w=w,
              exchange_kw={"compressor": "none"})
    np.testing.assert_allclose(dcd.losses.numpy(), dsgd.losses.numpy(),
                               rtol=1e-3)


def test_ecd_residual_feedback_with_biased_codec():
    """ECD's flat residual lets the biased 1-bit sign codec train."""
    ecd = run("ecd", n_workers=8, steps=300, lr=0.1)
    assert float(ecd.losses[-1]) < 0.25 * float(ecd.losses[0])


def test_acceptance_dcd_matches_sync_loss_at_quarter_bytes():
    """DCD-PSGD (rq4 deltas, ring W) reaches the synchronous
    full-precision loss within 5 % at equal iterations, at <= 1/4 of
    DSGD's fp32 gossip bytes."""
    steps, lr, d = 400, 0.2, 1024
    dcd = run("dcd", n_workers=8, steps=steps, lr=lr, d=d)
    sync = run("mbsgd", n_workers=8, steps=steps, lr=lr, d=d)
    dsgd = run("dsgd", n_workers=8, steps=steps, lr=lr, d=d)
    assert float(dcd.losses[-1]) <= 1.05 * float(sync.losses[-1])
    assert float(dcd.losses[-1]) < 0.9 * float(dcd.losses[0])
    assert dcd.comm_bytes_per_step <= dsgd.comm_bytes_per_step / 4
    assert isinstance(dcd.params, torch.Tensor)

"""The port's sharding rules and abstract train state against JAX's, at
full width, for every configuration.

For all 11 configs and both parameter trees (unrolled and scanned), the
port's ``steps.abstract_train_state`` (every leaf on ``meta``) equals
JAX's ``jax.eval_shape`` of ``init_train_state`` leaf for leaf — path,
shape, dtype — with error feedback on (and off for three of them), and
grok-1-314b's bf16 Adam moments (``dryrun.default_moment_dtype``). The
one difference is the key: the port keeps JAX's uint32 pair as an int64
host pair. The
spec of every leaf under the dry run's train-state rule (``param_spec``
for params and the ``m`` / ``v`` moments, the ``ec_err`` FSDP rule,
replication elsewhere) equals JAX's ``_state_shardings`` entry for
entry on both production meshes; so do ``cache_spec`` and ``batch_spec``
for every decode-state and batch leaf at ``decode_32k`` and
``long_500k``. JAX's own rule cases (``tests/test_sharding.py``) run on
the port's functions, and the mesh hooks are bit-identical no-ops on
plain tensors.

The meshes are JAX-style objects (``axis_names``, ``devices.shape``), as
JAX's tests use them; the spec functions read nothing else.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jsharding
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.optim import make_optimizer
from repro_torch.train import steps

ARCHS = tuple(configs.all_configs())


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": (FakeMesh((16, 16), ("data", "model")), ("data",)),
          "2x16x16": (FakeMesh((2, 16, 16), ("pod", "data", "model")),
                      ("pod", "data"))}


class FakeKey:
    def __init__(self, key):
        self.key = key


def _norm(spec) -> tuple:
    """A spec's entries with a 1-tuple of names as the bare name (JAX's
    ``PartitionSpec`` stores ('data',) as 'data'; both mean that axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _Spec:
    """A JAX spec held as a pytree leaf."""

    def __init__(self, spec):
        self.spec = _norm(spec)


def _jdryrun():
    """repro.launch.dryrun sets XLA_FLAGS for 512 host devices when
    imported: bring the backend up first and restore the flags."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jdr


def _jnames(path) -> tuple:
    return jsharding._path_names(path)


def _names(path) -> tuple:
    return tuple(str(p) for p in path)


# error feedback off: the flat residual is the one leaf it drops, so
# three configs (dense, MoE with bf16 moments, MoE with a dense layer)
NO_EF = ("qwen1.5-0.5b", "grok-1-314b", "deepseek-v2-lite-16b")


def _variants(arch):
    """(label, step_cfg kwargs) of the trees compared."""
    out = (("scan", dict(scan_layers=True, error_feedback=True)),
           ("unrolled", dict(scan_layers=False, error_feedback=True)))
    if arch in NO_EF:
        out += (("scan_no_ef", dict(scan_layers=True,
                                    error_feedback=False)),)
    return out


@pytest.fixture(scope="module")
def trees():
    """{(arch, variant): (jax leaves with paths, port leaves with paths)}
    built once: JAX's eval_shape and the port's meta state."""
    jdr = _jdryrun()
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        jopt = jmake_optimizer("adamw", 3e-4,
                               moment_dtype=jdr.default_moment_dtype(jcfg))
        opt = make_optimizer("adamw", 3e-4,
                             moment_dtype=dryrun.default_moment_dtype(cfg))
        for label, kw in _variants(arch):
            jst = jsteps.abstract_train_state(
                jcfg, jopt, step_cfg=jsteps.TrainStepConfig(**kw))
            st = steps.abstract_train_state(
                cfg, opt, step_cfg=steps.TrainStepConfig(**kw))
            out[(arch, label)] = (
                jst, jax.tree_util.tree_flatten_with_path(jst)[0],
                pytree.tree_flatten_with_path(st)[0])
    return out


@pytest.fixture
def batch_axes():
    yield
    jsharding.set_activation_batch_axes(("data",))
    sharding.set_activation_batch_axes(("data",))


def _set_axes(axes):
    jsharding.set_activation_batch_axes(axes)
    sharding.set_activation_batch_axes(axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_equals_jax_leaf_for_leaf(trees, arch):
    for label, _ in _variants(arch):
        _, jleaves, leaves = trees[(arch, label)]
        assert len(leaves) == len(jleaves), (arch, label)
        for (jp, jl), (p, leaf) in zip(jleaves, leaves):
            assert _names(p) == _jnames(jp), (arch, label)
            assert tuple(leaf.shape) == tuple(jl.shape), (arch, p)
            assert leaf.device.type == "meta"
            if _names(p) == ("rng",):
                assert (str(jl.dtype), leaf.dtype) == ("uint32", torch.int64)
                continue
            assert str(leaf.dtype).replace("torch.", "") == str(jl.dtype), \
                (arch, p)
    if arch == "grok-1-314b":
        _, _, leaves = trees[(arch, "scan")]
        moments = [leaf for p, leaf in leaves if p[0] == "opt"
                   and p[1] in ("m", "v")]
        assert moments and all(m.dtype == torch.bfloat16 for m in moments)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", tuple(MESHES))
def test_state_specs_equal_jax_on_the_production_meshes(
        trees, arch, mesh_name, monkeypatch, batch_axes):
    jdr = _jdryrun()
    mesh, axes = MESHES[mesh_name]
    _set_axes(axes)
    monkeypatch.setattr(jsharding, "NamedSharding", lambda m, s: _Spec(s))
    monkeypatch.setattr(jax.sharding, "NamedSharding",
                        lambda m, s: _Spec(s))
    for label in ("scan", "unrolled"):
        jst, _, leaves = trees[(arch, label)]
        jspecs = jax.tree_util.tree_leaves(jdr._state_shardings(jst, mesh))
        assert len(jspecs) == len(leaves)
        seen = set()
        for js, (p, leaf) in zip(jspecs, leaves):
            spec = dryrun._state_spec(p, leaf, mesh)
            assert _norm(spec) == js.spec, (arch, label, p)
            seen.add(p[0])
        assert {"params", "opt", "ec_err"} <= seen


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_cache_and_batch_specs_equal_jax_at_decode_shapes(arch, batch_axes):
    jdr = _jdryrun()
    for shape in ("decode_32k", "long_500k"):
        jspec = jdr.input_specs(arch, shape)
        spec = dryrun.input_specs(arch, shape)
        for mesh, axes in MESHES.values():
            _set_axes(axes)
            jstate = jax.tree_util.tree_flatten_with_path(
                jspec["decode_state"])[0]
            state = {_names(p): leaf for p, leaf in
                     pytree.tree_flatten_with_path(spec["decode_state"])[0]
                     if isinstance(leaf, torch.Tensor)}
            shared = 0
            for jp, jl in jstate:
                path = tuple(FakeKey(n) for n in _jnames(jp))
                want = _norm(jsharding.cache_spec(path, jl.shape, mesh))
                assert _norm(sharding.cache_spec(
                    path, tuple(jl.shape), mesh)) == want, (arch, shape, jp)
                leaf = state.get(_jnames(jp))
                if leaf is not None and tuple(leaf.shape) == tuple(jl.shape):
                    shared += 1
                    assert _norm(sharding.cache_spec(
                        _jnames(jp), tuple(leaf.shape), mesh)) == want
            assert shared > 0, (arch, shape)
            jbatch = jspec["batch"]
            assert sorted(jbatch) == sorted(spec["batch"])
            for k, jl in jbatch.items():
                leaf = spec["batch"][k]
                assert tuple(leaf.shape) == tuple(jl.shape)
                assert _norm(sharding.batch_spec(tuple(leaf.shape), mesh)) \
                    == _norm(jsharding.batch_spec(jl.shape, mesh))


def _spec(names, shape, mesh):
    path = tuple(FakeKey(n) for n in names)
    return _norm(sharding.param_spec(path, shape, mesh)), \
        _norm(jsharding.param_spec(path, shape, mesh))


M4 = FakeMesh((4, 4), ("data", "model"))
M1 = FakeMesh((1, 1), ("data", "model"))
M16 = FakeMesh((16, 16), ("data", "model"))

# JAX's rule cases (tests/test_sharding.py), held on the port's functions
RULE_CASES = [
    (("layers", "0", "mixer", "q", "w"), (1024, 2048), M1,
     ("data", "model")),
    (("layers", "0", "mixer", "o", "w"), (2048, 1024), M1,
     ("model", "data")),
    (("layers", "0", "ffn", "v", "w"), (2048, 1024), M1, ("model", "data")),
    (("layers", "0", "mixer", "v", "w"), (1024, 128), M1, ("data", "model")),
    (("scan_blocks", "0", "mixer", "q", "w"), (24, 1024, 2048), M4,
     (None, ("data",), "model")),
    (("layers", "0", "ffn", "w_gate"), (8, 4096, 32768), M4,
     (None, ("data",), "model")),
    (("layers", "0", "ffn", "w_down"), (8, 32768, 4096), M4,
     (None, "model", ("data",))),
    (("embed",), (151936, 1024), M16, ("model", "data")),
    (("final_norm", "scale"), (1024,), M16, ()),
]


@pytest.mark.parametrize("names,shape,mesh,want", RULE_CASES)
def test_param_rule_cases_equal_jax(names, shape, mesh, want):
    port, jx = _spec(names, shape, mesh)
    assert port == jx == _norm(want)
    assert sharding.param_spec(tuple(FakeKey(n) for n in names), shape,
                               mesh) == want


def test_maybe_divisibility_and_cache_and_batch_rules():
    assert sharding._maybe("model", 7, M1) == "model"
    assert sharding._maybe("model", 7, M4) is None
    assert sharding._maybe("model", 8, M4) == "model"
    assert sharding._maybe(("data",), 8, M4) == ("data",)
    assert sharding._maybe("pod", 8, M4) is None
    path = tuple(FakeKey(n) for n in ("layers", "0", "k"))
    # kv_heads 8 do not divide 16: head_dim 128 is sharded instead
    for shape, want in (((128, 32768, 8, 128), ("data", None, None, "model")),
                        ((128, 32768, 16, 64), ("data", None, "model", None))):
        assert sharding.cache_spec(path, shape, M16) == want == \
            _norm(jsharding.cache_spec(path, shape, M16))
    assert sharding.batch_spec((256, 4096), M16) == (("data",), None)
    assert sharding.batch_spec((1, 524288), M16) == (None, None)


def test_mesh_hooks_are_bit_identical_no_ops_on_plain_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 8, generator=g)
    for hook in (sharding.constrain_act, sharding.constrain_heads,
                 sharding.unshard):
        assert hook(x) is x
    tree = {"a": x, "b": [x[0]]}
    assert sharding.unshard_tree(tree)["a"] is x
    assert sharding.like(x, x[0]) is x
    assert torch.equal(sharding.split_heads(x.reshape(2, 3, 32), 4, 8), x)
    logits = torch.randn(2, 3, 11, generator=g)
    labels = torch.randint(0, 11, (2, 3), generator=g)
    assert torch.equal(sharding.take_label_logits(logits, labels),
                       logits.gather(-1, labels[..., None])[..., 0])
    cache = torch.zeros(2, 5, 3)
    want = cache.clone()
    slot, val = torch.tensor([4, 1]), torch.randn(2, 3, generator=g)
    want[torch.arange(2), slot] = val
    sharding.write_rows(cache, torch.arange(2), slot, val)
    assert torch.equal(cache, want)
    assert torch.equal(sharding.replicate_call(torch.add, x, 1.0), x + 1.0)


def test_flatten_keeps_no_leaf_alive_after_it_is_dropped():
    """A flattened or rebuilt tree holds its leaves only while it is
    referenced: the walks are module-level functions, not
    self-referencing closures (a closure cycle kept every leaf of a
    flatten alive until the cycle collector ran, which the dry run's
    live-bytes count and the card's peak both saw)."""
    import gc
    import weakref
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        leaves, treedef = pytree.tree_flatten({"a": [t], "b": None})
        tree = pytree.tree_unflatten(treedef, leaves)
        pairs, _ = pytree.tree_flatten_with_path(tree)
        assert pairs[0][0] == ("a", 0)
        del t, leaves, tree, pairs
        assert ref() is None
    finally:
        gc.enable()

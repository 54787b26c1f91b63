"""Where the benchmark meets the program (``repro_torch``): the model
configuration it runs, held to the configuration file's numbers, and
the benchmark's weights handed to it in its parameter tree.
"""
from __future__ import annotations

from reference import layout

# the model numbers of a configuration file, named as the program's
# ModelConfig fields
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
          "d_ff", "vocab", "qkv_bias", "rope_theta", "norm_eps",
          "tie_embeddings")


def model_config(m: dict):
    """The program's configuration of ``m["arch"]`` (``smoke``: its own
    smoke-test variant, for CPU tests), held to ``m``'s numbers."""
    from repro_torch import configs
    cfg = configs.get_config(m["arch"])
    if m.get("smoke"):
        cfg = cfg.reduced()
    check_config(cfg, m)
    return cfg


def check_config(cfg, m: dict) -> None:
    """Raise unless the program runs the numbers the file states."""
    bad = {k: (getattr(cfg, k), m[k]) for k in FIELDS
           if getattr(cfg, k) != m[k]}
    plain = (cfg.norm == "rmsnorm" and cfg.act == "silu" and cfg.glu
             and cfg.rope_variant == "rope" and not cfg.out_bias
             and not cfg.parallel_block and cfg.logit_softcap == 0
             and cfg.moe is None and set(cfg.block_pattern) == {"attn"})
    if bad or not plain:
        raise ValueError(f"{m['arch']}: the program's configuration departs "
                         f"from the file: {bad or 'block kind'}")


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {}) if isinstance(key, str) else tree[key]
    tree[path[-1]] = value


def param_tree(W: dict) -> dict:
    """The program's scanned parameter tree over the tensors of ``W``."""
    tree = {"prefix_layers": [], "scan_blocks": [{}], "suffix_layers": []}
    for name, t in W.items():
        _put(tree, layout.PATHS[name], t)
    return tree


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def check_tree(got: dict, want: dict) -> None:
    """Raise unless two parameter trees have the same keys and shapes."""
    from repro_torch.core import pytree
    got_l, got_t = pytree.tree_flatten(got)
    want_l, want_t = pytree.tree_flatten(want)
    if got_t != want_t or [tuple(t.shape) for t in got_l] != \
            [tuple(t.shape) for t in want_l]:
        raise ValueError("the benchmark's weights do not fill the "
                         "program's parameter tree")


def load_params(params: dict, W: dict) -> None:
    """Copy the benchmark's weights into the program's own leaves (its
    tree and shapes checked first)."""
    check_tree(param_tree(W), params)
    for name, t in W.items():
        get(params, layout.PATHS[name]).copy_(t)

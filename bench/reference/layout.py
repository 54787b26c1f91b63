"""The weights of a pre-norm GQA decoder, by name, and the order in which
the compressed gradient lays them out.

Every per-layer weight is stacked over the layers (a leading dim of
``n_layers``). A dense weight is (d_in, d_out), applied as ``x @ w``.
``PATHS`` gives each weight its place in the nested parameter tree the
gradient message is cut from: the message concatenates the leaves in
the order of their paths, dict keys sorted at every level, which is the
published wire layout of the flat codec. The benchmark hands the same
weights to the program under these paths.
"""
from __future__ import annotations

import math

_BLOCK = ("scan_blocks", 0)

PATHS = {
    "embed": ("embed",),
    "final_norm": ("final_norm", "scale"),
    "ln1": _BLOCK + ("ln1", "scale"),
    "ln2": _BLOCK + ("ln2", "scale"),
    "wq": _BLOCK + ("mixer", "q", "w"),
    "bq": _BLOCK + ("mixer", "q", "b"),
    "wk": _BLOCK + ("mixer", "k", "w"),
    "bk": _BLOCK + ("mixer", "k", "b"),
    "wv": _BLOCK + ("mixer", "v", "w"),
    "bv": _BLOCK + ("mixer", "v", "b"),
    "wo": _BLOCK + ("mixer", "o", "w"),
    "w_up": _BLOCK + ("ffn", "up", "w"),
    "w_gate": _BLOCK + ("ffn", "gate", "w"),
    "w_down": _BLOCK + ("ffn", "down", "w"),
}

# Weights that enter a matmul (the tied head is the embedding, once).
MATMUL = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


def shapes(m: dict) -> dict:
    """name -> shape for the model sizes ``m`` (the configuration file's
    ``model`` block)."""
    L, d, f, v = m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    out = {"embed": (v, d), "final_norm": (d,), "ln1": (L, d),
           "ln2": (L, d), "wq": (L, d, q), "wk": (L, d, kv),
           "wv": (L, d, kv), "wo": (L, q, d), "w_up": (L, d, f),
           "w_gate": (L, d, f), "w_down": (L, f, d)}
    if m["qkv_bias"]:
        out.update(bq=(L, q), bk=(L, kv), bv=(L, kv))
    if not m["tie_embeddings"]:
        raise ValueError("only tied-embedding models are laid out here")
    return out


def flat_order(m: dict) -> list:
    """The names in the order of the gradient message."""
    return sorted(shapes(m), key=lambda n: PATHS[n])


def init_spec(m: dict) -> dict:
    """name -> (std, mean) of the benchmark's random weights: normal
    draws, 0.02 for the embedding and the biases, 1/sqrt(d_in) for a
    dense weight, 1 + 0.1 n for a norm's scale (so every term of the
    block is exercised)."""
    spec = {}
    for name, shape in shapes(m).items():
        if name == "embed" or name.startswith("b"):
            spec[name] = (0.02, 0.0)
        elif name in ("final_norm", "ln1", "ln2"):
            spec[name] = (0.1, 1.0)
        else:
            spec[name] = (1.0 / math.sqrt(shape[-2]), 0.0)
    return spec

"""The weights of DeepSeek-V2-Lite's decoder (MLA blocks, a dense first
layer, MoE layers with shared experts, an untied head), by name, as the
plain reference (``reference.deepseek``) takes them, and how the
benchmark draws them.

A weight of the attention or the norms is stacked over all ``n_layers``
layers; the dense FFN over the ``first_k_dense`` leading layers; the
router, the routed experts (E, d_in, d_out) and the shared experts over
the MoE layers (the shared ones with the expert index first). A dense
weight is (d_in, d_out), applied as ``x @ w``. The published
``kv_b_proj`` is kept as its two column blocks ``wk_b`` (the no-rope
keys) and ``wv_b`` (the values), each in head-major order, and the
published shared MLP of ``n_shared * d_ff_expert`` hidden units as
``n_shared`` blocks of ``d_ff_expert``: the same functions.
"""
from __future__ import annotations

import math


def shapes(m: dict) -> dict:
    """name -> shape for the model sizes ``m`` (the configuration file's
    ``model`` block)."""
    L, d, h, v = m["n_layers"], m["d_model"], m["n_heads"], m["vocab"]
    r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                     m["qk_rope_head_dim"], m["v_head_dim"])
    nd = m["first_k_dense"]
    nm = L - nd
    e, f, fe, ns = m["n_experts"], m["d_ff"], m["d_ff_expert"], m["n_shared"]
    return {"embed": (v, d), "final_norm": (d,), "lm_head": (d, v),
            "ln1": (L, d), "ln2": (L, d),
            "wq": (L, d, h * (dn + dr)), "w_kv_a": (L, d, r + dr),
            "kv_norm": (L, r), "wk_b": (L, r, h * dn), "wv_b": (L, r, h * dv),
            "wo": (L, h * dv, d),
            "dense_gate": (nd, d, f), "dense_up": (nd, d, f),
            "dense_down": (nd, f, d),
            "router": (nm, d, e),
            "experts_gate": (nm, e, d, fe), "experts_up": (nm, e, d, fe),
            "experts_down": (nm, e, fe, d),
            "shared_gate": (ns, nm, d, fe), "shared_up": (ns, nm, d, fe),
            "shared_down": (ns, nm, fe, d)}


NORMS = ("final_norm", "ln1", "ln2", "kv_norm")


def init_spec(m: dict) -> dict:
    """name -> (std, mean) of the benchmark's random weights: 0.02 for the
    embedding, 1 + 0.1 n for a norm's scale, 1/sqrt(d_in) for a dense
    weight (the head and the router included)."""
    spec = {}
    for name, shape in shapes(m).items():
        if name == "embed":
            spec[name] = (0.02, 0.0)
        elif name in NORMS:
            spec[name] = (0.1, 1.0)
        else:
            spec[name] = (1.0 / math.sqrt(shape[-2]), 0.0)
    return spec

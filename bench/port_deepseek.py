"""Where the benchmark meets the program for DeepSeek-V2-Lite: the
program's configuration held to the configuration file's numbers, and
the reference's weights (``reference.deepseek_layout``) handed to the
program's scanned parameter tree as views, nothing copied: layer 0 (the
dense prefix) takes index 0 of each attention weight stacked over the
layers, the scanned MoE layers the rest.
"""
from __future__ import annotations

# the file's numbers, named as the program's ModelConfig / MLAConfig /
# MoEConfig / YaRNConfig fields
MODEL = ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "rope_theta",
         "norm_eps", "tie_embeddings")
MLA = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
       "v_head_dim")
MOE = ("n_experts", "top_k", "d_ff_expert", "n_shared")
YARN = ("factor", "original_max_position_embeddings", "beta_fast",
        "beta_slow", "mscale", "mscale_all_dim")


def program_config(m: dict):
    """The program's configuration of ``m["arch"]`` (``smoke``: its own
    smoke-test variant, for CPU tests)."""
    from repro_torch import configs
    cfg = configs.get_config(m["arch"])
    return cfg.reduced() if m.get("smoke") else cfg


def model_dict(m: dict) -> dict:
    """``m``, or for a ``smoke`` run ``m`` with the sizes of the program's
    smoke-test variant (the reference then runs that tiny model)."""
    if not m.get("smoke"):
        return m
    cfg = program_config(m)
    out = dict(m, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab)
    out.update({k: getattr(cfg.mla, k) for k in MLA})
    out.update({k: getattr(cfg.moe, k) for k in MOE})
    return out


def model_config(m: dict):
    """The program's configuration, held to ``m``'s numbers."""
    cfg = program_config(m)
    check_config(cfg, m)
    return cfg


def check_config(cfg, m: dict) -> None:
    """Raise unless the program runs the numbers the file states (the
    dropless path keeps the router's probabilities as the gates, the
    file's ``norm_topk_prob`` false)."""
    bad = {k: (getattr(cfg, k), m[k]) for k in MODEL
           if getattr(cfg, k) != m[k]}
    bad.update({k: (getattr(cfg.mla, k), m[k]) for k in MLA
                if cfg.mla is None or getattr(cfg.mla, k) != m[k]})
    bad.update({k: (getattr(cfg.moe, k), m[k]) for k in MOE
                if cfg.moe is None or getattr(cfg.moe, k) != m[k]})
    ys = cfg.rope_scaling
    bad.update({k: (ys and getattr(ys, k), m["rope_scaling"][k])
                for k in YARN
                if ys is None or getattr(ys, k) != m["rope_scaling"][k]})
    kind = (cfg.norm == "rmsnorm" and cfg.act == "silu" and cfg.glu
            and cfg.rope_variant == "rope" and cfg.moe.dropless
            and m["norm_topk_prob"] is False
            and set(cfg.block_pattern) == {"mla"}
            and m["first_k_dense"] == 1 and cfg.logit_softcap == 0)
    if bad or not kind:
        raise ValueError(f"{m['arch']}: the program's configuration departs "
                         f"from the file: {bad or 'block kind'}")


def param_tree(W: dict) -> dict:
    """The program's scanned parameter tree over the tensors of ``W``."""
    def mixer(i):
        return {"q_proj": {"w": W["wq"][i]},
                "kv_down": {"w": W["w_kv_a"][i]},
                "kv_norm": {"scale": W["kv_norm"][i]},
                "k_up": {"w": W["wk_b"][i]}, "v_up": {"w": W["wv_b"][i]},
                "o": {"w": W["wo"][i]}}
    rest = slice(1, None)
    dense = {"ln1": {"scale": W["ln1"][0]}, "mixer": mixer(0),
             "ln2": {"scale": W["ln2"][0]},
             "ffn": {"gate": {"w": W["dense_gate"][0]},
                     "up": {"w": W["dense_up"][0]},
                     "down": {"w": W["dense_down"][0]}}}
    ffn = {"router": {"w": W["router"]}, "w_gate": W["experts_gate"],
           "w_up": W["experts_up"], "w_down": W["experts_down"]}
    for i in range(W["shared_gate"].shape[0]):
        ffn[f"shared_{i}"] = {"gate": {"w": W["shared_gate"][i]},
                              "up": {"w": W["shared_up"][i]},
                              "down": {"w": W["shared_down"][i]}}
    moe = {"ln1": {"scale": W["ln1"][rest]}, "mixer": mixer(rest),
           "ln2": {"scale": W["ln2"][rest]}, "ffn": ffn}
    return {"embed": W["embed"], "final_norm": {"scale": W["final_norm"]},
            "lm_head": {"w": W["lm_head"]}, "prefix_layers": [dense],
            "scan_blocks": [moe], "suffix_layers": []}

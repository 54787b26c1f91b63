"""``expert_load.prefill``: the program's histogram ``moe.expert_load`` in
its metrics registry (one sample a MoE layer call in the traced window:
the busiest expert's choices over the mean), its mean. The counter
``moe.dropped_choices`` beside it (every (token, choice) less those
computed) is noted on standard error; dropless routing drops none. A
program that keeps no such histogram reads nothing."""
import harness


def read(run, trace):
    from repro_torch.obs import metrics
    snap = metrics.registry().snapshot()
    load = snap.get("moe.expert_load")
    if not load or not load.get("count"):
        return None
    dropped = snap.get("moe.dropped_choices", {}).get("value", 0.0)
    harness.note(f"expert_load: {load['count']} MoE layer calls, "
                 f"{dropped:g} choices dropped")
    return load["mean"]

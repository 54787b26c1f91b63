"""Serving tier of the port: continuous-batching engine + live checkpoint
hot-swap over the rq8 wire, on ``cuda`` unless ``device="cpu"``.

    from repro_torch import serve

    cfg = serve.ServeConfig(slots=4, n_requests=16, mixed_gen=(4, 8, 32))
    res = serve.run(cfg)                      # ServeResult, on the card
    res = serve.run(cfg, device="cpu")        # plain PyTorch on the CPU

    eng = serve.Engine(cfg)                   # request-level control
    rid = eng.submit(tokens, max_new_tokens=32)
    eng.subscribe(channel); eng.run()

    ch = serve.CheckpointChannel()            # train -> serve wire
    ch.publish(params, step=1, codec="rq8")
"""
from repro_torch.serve.api import (ServeResult, format_result, run,
                                   synthetic_requests)
from repro_torch.serve.channel import (CheckpointChannel,
                                       PublishedCheckpoint,
                                       publish_train_state)
from repro_torch.serve.engine import (AdmissionError, Completion, Engine,
                                      Request, ServeConfig)

__all__ = [
    "AdmissionError", "CheckpointChannel", "Completion", "Engine",
    "PublishedCheckpoint", "Request", "ServeConfig", "ServeResult",
    "format_result", "publish_train_state", "run", "synthetic_requests",
]

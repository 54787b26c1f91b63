"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

Module paths mirror ``repro``: ``repro/x/y.py`` has its counterpart in
``repro_torch/x/y.py``. The package imports torch and numpy only — never
jax and nothing of ``repro`` — and its entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

Ported so far: the serving path (``serve``, ``models.transformer_scan``
for attention-only stacks, ``train.steps``' serve and prefill step
factories), the rq8/rq4/rq2 checkpoint codec (``core.compression`` on
the ``kernels.quant`` CUDA kernels, ``csrc/quant.cu``), and the training
path on one card (``launch.train``, ``train.steps.make_train_step`` with
the fused rq gradient compression and error feedback, ``optim``,
``data.pipeline.SyntheticLM``, ``checkpoint.npz``, the full-sequence
``apply`` / ``loss_fn`` of both parameter trees), and the paper's
algorithm tier (``core.parallel``, ``core.communicators``,
``core.mixing``: workers stacked on one device, the partitioned ring
AllReduce on its own fused kernel).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Field-wise equality of a port configuration with the JAX package's.

The port's ``ModelConfig`` and ``MoEConfig`` have fields that JAX's lack
(``rope_scaling``; ``dropless``), so the two dataclasses' ``asdict`` no
longer compare equal. ``assert_same_config``
compares every field that JAX's dataclass has, nested groups (``moe``,
``mla``) the same way, and asserts each port-only field at its default.
"""
from __future__ import annotations

import dataclasses


def assert_same_config(port, jax, path: str = "") -> None:
    if not dataclasses.is_dataclass(jax):
        assert port == jax, path
        return
    names = set()
    for f in dataclasses.fields(jax):
        names.add(f.name)
        assert_same_config(getattr(port, f.name), getattr(jax, f.name),
                           f"{path}.{f.name}")
    for f in dataclasses.fields(port):
        if f.name not in names:
            assert getattr(port, f.name) == f.default, f"{path}.{f.name}"

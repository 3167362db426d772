"""Frozen dataclasses that are JAX pytrees.

`@dataclass` registers the class with jax.tree_util: every field is a child
of the tree unless it was declared with `field(pytree_node=False)`, which
makes it static metadata (part of the tree's structure, so a jit argument
carrying it recompiles when it changes). Instances are immutable; `.replace`
returns a copy with some fields changed.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a pytree_node flag (False = static field)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls

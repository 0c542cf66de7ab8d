"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree leaves, except
those declared with `field(pytree_node=False)`: those are static metadata,
kept in the treedef, so a change of their value retraces a jitted function.
Instances get a `.replace(**changes)` method (`dataclasses.replace`).
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Turn `cls` into a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[
            f.name for f in fields if not f.metadata.get("pytree_node", True)
        ],
    )
    cls.replace = dataclasses.replace
    return cls

"""Pytree dataclasses with static (non-traced) fields.

The reference depends on a forked chex for ``@chex.dataclass`` with
``static_keynames`` support (reference: pyproject.toml:22, CHANGELOG.md:140-144,
used at examples/seirs_multi_strain_age_stratified.py:177). This module is the
in-repo replacement: a thin wrapper over ``dataclasses.dataclass`` +
``jax.tree_util.register_dataclass`` so that

- array/pytree fields are traced leaves (flow through jit/vmap/grad), and
- fields named in ``static_fieldnames`` are metadata baked into the XLA
  program (e.g. ``idx`` namespaces used for compartment indexing).

Changing a static field triggers recompilation, which is exactly the
semantics compartment-index namespaces need.
"""

import dataclasses
from typing import Iterable, Optional, Sequence, Type, TypeVar, Union

import jax

_T = TypeVar("_T")


def _as_tuple(names: Union[str, Iterable[str], None]) -> tuple:
    if names is None:
        return ()
    if isinstance(names, str):
        return (names,)
    return tuple(names)


def pytree_dataclass(
    cls: Optional[Type[_T]] = None,
    *,
    static_fieldnames: Union[str, Sequence[str], None] = None,
    static_keynames: Union[str, Sequence[str], None] = None,
    frozen: bool = False,
):
    """Create a dataclass registered as a JAX pytree.

    Parameters
    ----------
    cls : type, optional
        The class to decorate. When omitted, returns a decorator (so both
        ``@pytree_dataclass`` and ``@pytree_dataclass(...)`` work).
    static_fieldnames : str | Sequence[str], optional
        Field names treated as static metadata rather than traced leaves.
    static_keynames : str | Sequence[str], optional
        Alias of ``static_fieldnames`` for drop-in parity with the chex fork
        used by the reference (examples/seirs_multi_strain_age_stratified.py:177).
    frozen : bool
        Whether the dataclass is immutable. Defaults to False to match chex
        dataclass ergonomics.
    """
    static = _as_tuple(static_fieldnames) + _as_tuple(static_keynames)

    def wrap(inner_cls: Type[_T]) -> Type[_T]:
        dc = dataclasses.dataclass(inner_cls, frozen=frozen, eq=False)
        field_names = [f.name for f in dataclasses.fields(dc)]
        unknown = set(static) - set(field_names)
        if unknown:
            raise ValueError(
                f"static field names {sorted(unknown)} not found among "
                f"dataclass fields {field_names}"
            )
        data_fields = [n for n in field_names if n not in static]
        meta_fields = [n for n in field_names if n in static]
        jax.tree_util.register_dataclass(
            dc, data_fields=data_fields, meta_fields=meta_fields
        )

        def replace(self, **updates):
            """Return a copy of this dataclass with the given fields replaced."""
            return dataclasses.replace(self, **updates)

        dc.replace = replace  # type: ignore[attr-defined]
        return dc

    if cls is None:
        return wrap
    return wrap(cls)


def field(**kwargs):
    """Passthrough to :func:`dataclasses.field` for symmetry."""
    return dataclasses.field(**kwargs)


__all__ = ["pytree_dataclass", "field"]

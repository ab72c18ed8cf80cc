"""Converters from the reference package's plain forms to the port's objects.

The system has no weights; its state is data: circuits, characterizations
and energy-model tables.  Both packages serialize those to the same plain
forms, and this module builds the port's objects from them, so both can
compute on identical operands.  It takes plain dicts, tuples and numpy
arrays only — never objects of the reference package:

  * ``Aig.to_dict()``       -> `aig_from_dict`
  * ``AigStats.to_dict()``  -> `stats_from_dict` / `cha_from_dicts`
  * a ``ModelTable``'s numpy field arrays -> `model_table_from_arrays`
  * topology lists as ``(rows, cols, macros)`` tuples -> `topologies_from_tuples`

The port's copies keep those dict formats byte-compatible (fingerprints
and `CharacterizationCache` entries are interchangeable).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from .aig import Aig, AigStats
from .sram import _GEOMETRY, ModelTable, SramTopology


def aig_from_dict(d: Mapping) -> Aig:
    return Aig.from_dict(dict(d))


def stats_from_dict(d: Mapping) -> AigStats:
    return AigStats.from_dict(dict(d))


def cha_from_dicts(
    cha: Mapping[str, Mapping[Sequence[str], Mapping]],
) -> dict[str, dict[tuple[str, ...], AigStats]]:
    """``{circuit: {recipe: AigStats.to_dict()}}`` -> the port's cha map."""
    return {
        name: {tuple(r): stats_from_dict(s) for r, s in per.items()}
        for name, per in cha.items()
    }


def model_table_fields() -> tuple[str, ...]:
    """The array fields of a `ModelTable` (everything but the names)."""
    return tuple(
        f.name
        for f in dataclasses.fields(ModelTable)
        if f.name not in ("names", "topology_names")
    )


def model_table_from_arrays(
    names: Sequence[str],
    fields: Mapping[str, np.ndarray],
    topology_names: Sequence[str] | None = None,
) -> ModelTable:
    """A port `ModelTable` from the reference's numpy field arrays."""
    missing = [f for f in model_table_fields() if f not in fields]
    if missing:
        raise ValueError(f"ModelTable fields missing: {missing}")
    return ModelTable(
        names=tuple(names),
        topology_names=None if topology_names is None else tuple(topology_names),
        **{
            f: np.array(fields[f], dtype=np.float64, copy=True)
            for f in model_table_fields()
        },
    )


def topologies_from_tuples(
    tuples: Iterable[Sequence[int]],
) -> list[SramTopology]:
    """``(rows, cols, macros)`` tuples -> topologies.  A geometry that is
    the paper's library geometry for its size becomes the library entry
    (so names and equality match the library); any other becomes a
    `SramTopology.from_geometry` design point."""
    out = []
    for rows, cols, macros in tuples:
        kb, rem = divmod(int(rows) * int(cols), 8192)
        if not rem and _GEOMETRY.get(kb) == (int(rows), int(cols)):
            out.append(SramTopology(kb, int(macros)))
        else:
            out.append(SramTopology.from_geometry(int(rows), int(cols), int(macros)))
    return out

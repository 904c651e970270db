"""Static variable layouts: pytree-friendly replacement for casadi structs.

The reference addresses variables through string-keyed casadi structs
(struct_symSX) at expression-build time. On TPU, all structure must be
resolved before tracing: a :class:`VarLayout` maps ``(var_type, name)`` to a
static slice of a flat vector, so jitted code only ever does constant-offset
slicing (free under XLA) and the same layout doubles as the gather/scatter
index map for the stage-structured NLP.

Variable types follow the reference model convention
(awebox mdl/system.py:224-228):
``x`` states, ``xdot`` state derivatives, ``u`` controls, ``z`` algebraic
variables, ``theta`` free design parameters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

VAR_TYPES = ('x', 'xdot', 'u', 'z', 'theta')


class VarLayout:
    """Ordered (name, dim) lists per variable type with static slices."""

    def __init__(self, entries: Dict[str, Sequence[Tuple[str, int]]]):
        self.entries: Dict[str, List[Tuple[str, int]]] = {
            t: [(n, int(d)) for (n, d) in entries.get(t, [])] for t in VAR_TYPES}
        self.slices: Dict[str, Dict[str, slice]] = {}
        self.dims: Dict[str, int] = {}
        for t in VAR_TYPES:
            offset = 0
            self.slices[t] = {}
            for name, dim in self.entries[t]:
                self.slices[t][name] = slice(offset, offset + dim)
                offset += dim
            self.dims[t] = offset
        # offsets of each type within the concatenated model-variables vector
        self.type_offsets: Dict[str, int] = {}
        total = 0
        for t in VAR_TYPES:
            self.type_offsets[t] = total
            total += self.dims[t]
        self.total_dim = total

    # --- queries ----------------------------------------------------------
    def names(self, var_type: str) -> List[str]:
        return [n for n, _ in self.entries[var_type]]

    def dim(self, var_type: str, name: str | None = None) -> int:
        if name is None:
            return self.dims[var_type]
        s = self.slices[var_type][name]
        return s.stop - s.start

    def has(self, var_type: str, name: str) -> bool:
        return name in self.slices[var_type]

    def var_type_of(self, name: str):
        """First variable type containing `name`, searching x, u, z, theta."""
        for t in ('x', 'u', 'z', 'theta'):
            if self.has(t, name):
                return t
        return None

    # --- vector packing ---------------------------------------------------
    def get(self, vec, var_type: str, name: str):
        return vec[self.slices[var_type][name]]

    def pack(self, var_type: str, values: Dict[str, object], default=0.0, xp=np):
        """Pack a name->array dict into a flat vector (numpy by default)."""
        parts = []
        for name, dim in self.entries[var_type]:
            if name in values:
                v = xp.reshape(xp.asarray(values[name], dtype=float), (-1,))
                if v.shape[0] == 1 and dim > 1:
                    v = xp.broadcast_to(v, (dim,))
                assert v.shape[0] == dim, f'{var_type}.{name}: {v.shape[0]} != {dim}'
            else:
                v = xp.full((dim,), default, dtype=float)
            parts.append(v)
        if not parts:
            return xp.zeros((0,))
        return xp.concatenate(parts)

    def unpack(self, var_type: str, vec) -> Dict[str, object]:
        return {name: vec[self.slices[var_type][name]] for name, _ in self.entries[var_type]}

    def expand_per_name(self, var_type: str, values_by_name: Dict[str, object],
                        fallback=1.0) -> np.ndarray:
        """Build a full per-entry vector from a name->value map, broadcasting
        scalars, with a split-name fallback: 'dq21' falls back to 'dq', then to
        `fallback`. Mirrors the lookup in mdl/dynamics.py:824-921."""
        out = np.ones(self.dims[var_type]) * fallback
        for name, dim in self.entries[var_type]:
            value = None
            if name in values_by_name:
                value = values_by_name[name]
            else:
                stripped = strip_node_identifier(name)
                if stripped in values_by_name:
                    value = values_by_name[stripped]
            if value is not None:
                v = np.reshape(np.asarray(value, dtype=float), (-1,))
                if v.shape[0] == 1 and dim > 1:
                    v = np.broadcast_to(v, (dim,))
                out[self.slices[var_type][name]] = v
        return out


def strip_node_identifier(name: str) -> str:
    """'dq21' -> 'dq'; 'lambda10' -> 'lambda'; 'l_t' -> 'l_t' (underscored
    names keep digits); matches struct_op.split_name_and_node_identifier."""
    if '_' in name:
        return name
    stripped = name.rstrip('0123456789')
    return stripped if stripped else name


class VarView:
    """Convenience view over a dict of type->flat-vector with a VarLayout."""

    def __init__(self, layout: VarLayout, vectors: Dict[str, object]):
        self.layout = layout
        self.vectors = vectors

    def __getitem__(self, key: Tuple[str, str]):
        var_type, name = key
        return self.layout.get(self.vectors[var_type], var_type, name)

    def typed(self, var_type: str):
        return self.vectors[var_type]

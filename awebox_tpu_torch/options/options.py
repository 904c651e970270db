"""Typed options container with dotted-path overrides.

Mirrors the semantics of the reference options system
(awebox opts/options.py:32-140): a nested tree of defaults,
user overrides addressed by dotted paths ('user_options.wind.u_ref'), type
checking against the default's type, and a two-stage build
(raw -> architecture-aware processed options with derived scalings).

The processed result is a plain nested dict of Python/numpy values; everything
numeric that enters jitted code is packed later into parameter pytrees by the
model builder, so that sweeps can vmap over parameter values.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

from . import defaults as _defaults


def _is_number(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating))


class Options:
    """Dict-of-dicts options tree with dotted-path access."""

    def __init__(self, seed: Dict[str, Any] | None = None):
        self._tree = _defaults.default_options_tree()
        if seed:
            for key, value in seed.items():
                self[key] = value

    # --- access -----------------------------------------------------------
    def _resolve(self, path: str):
        parts = path.split('.')
        node = self._tree
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown options path: {path!r} (at {p!r})")
            node = node[p]
        return node, parts[-1]

    def __getitem__(self, path: str):
        node, leaf = self._resolve(path)
        if leaf not in node:
            raise KeyError(f"unknown option: {path!r}")
        return node[leaf]

    def __setitem__(self, path: str, value):
        node, leaf = self._resolve(path)
        if leaf not in node:
            raise KeyError(f"unknown option: {path!r}")
        default = node[leaf]
        # typed assignment: allow None defaults to take anything; numbers are
        # interchangeable; otherwise require matching container type.
        if default is not None and value is not None:
            if _is_number(default) and not (_is_number(value) or isinstance(value, np.ndarray)):
                raise TypeError(
                    f"option {path!r} expects a number, got {type(value).__name__}")
            if isinstance(default, str) and not isinstance(value, str):
                raise TypeError(
                    f"option {path!r} expects a string, got {type(value).__name__}")
            if isinstance(default, dict) and not isinstance(value, dict):
                raise TypeError(
                    f"option {path!r} expects a dict, got {type(value).__name__}")
        node[leaf] = value

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except KeyError:
            return False

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._tree)

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> 'Options':
        """Rebuild from a full options tree (the save/reload path,
        reference trial.py:62-76: seed can be a loaded dict). The stored
        tree is merged onto fresh defaults, so files saved before an option
        existed still load (new options keep their default)."""
        obj = cls()

        def merge(dst, src):
            for key, val in src.items():
                # config subtrees (string keys) merge; value dicts like the
                # architecture parent map (int keys) replace wholesale
                if (isinstance(val, dict) and isinstance(dst.get(key), dict)
                        and all(isinstance(k, str)
                                for k in list(val) + list(dst[key]))):
                    merge(dst[key], val)
                else:
                    dst[key] = copy.deepcopy(val)

        merge(obj._tree, tree)
        return obj

    # --- build ------------------------------------------------------------
    def build(self, architecture):
        """Process raw options into architecture-aware options, including the
        load-bearing scaling estimates (reference opts/model_funcs.py:1141-1473).
        Returns a plain nested dict."""
        from . import derived
        return derived.build_processed_options(self.as_dict(), architecture)

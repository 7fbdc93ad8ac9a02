"""YACS-style config tree.

Behavioral equivalent of the reference's config layer
(`nerface_code/nerf-pytorch/nerf/cfgnode.py:36-419`): a nested dict with
attribute access, immutability toggles, YAML round-tripping, file/list
merging, and value coercion.  Accepts the reference's experiment YAML files
unchanged (e.g. `config/dave/dave_dvp_lcode_fixed_bg_512_paper_model.yml`).

Derivation note: the reference's CfgNode is itself a YACS derivative, and
the public API here matches it by necessity (the 62 shipped YAMLs and the
CLI `--override key value` path go through it). The implementation is our
own: merging and leaf-coercion are CfgNode methods driven by a declarative
cast table rather than YACS's recursive module functions, and dotted-path
handling is shared by merge and override. The deprecated/renamed-key
registry is kept as a minimal API-parity hook — no shipped config uses it.

Copied from `nerface_tpu/config/cfgnode.py` so the PyTorch port never
imports the JAX package. `yaml` is imported where it is used: a host that
builds its config as a dict needs no PyYAML.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Leaf types a config may hold (matches YAML's scalar/sequence model).
_LEAF_TYPES = (tuple, list, str, int, float, bool, type(None))

# Silent leaf coercions applied when an override's type differs from the
# existing value's type: {incoming type: allowed existing type}.
_COERCIONS: Dict[type, type] = {tuple: list, list: tuple, int: float}


class CfgNode(dict):
    """A nested configuration node with attribute access and freezing.

    Internal state (frozen flag, deprecation registry) lives on
    ``self.__dict__`` so the dict payload stays pure config.
    """

    def __init__(self, init_dict: Optional[Dict] = None, key_list: Optional[List[str]] = None):
        path = tuple(key_list or ())
        super().__init__()
        self.__dict__["_frozen"] = False
        self.__dict__["_deprecated"] = set()
        self.__dict__["_renamed"] = {}
        for k, v in (init_dict or {}).items():
            self[str(k)] = self._wrap_value(v, path + (str(k),))

    @classmethod
    def _wrap_value(cls, value: Any, path: Tuple[str, ...]) -> Any:
        """Deep-convert dicts to CfgNodes; reject non-config leaf types."""
        if isinstance(value, CfgNode):
            return value
        if isinstance(value, dict):
            return cls(value, key_list=list(path))
        if type(value) not in _LEAF_TYPES:
            raise AttributeError(
                f"config value at '{'.'.join(path)}' has unsupported type "
                f"{type(value).__name__}; config leaves must be one of "
                f"{[t.__name__ for t in _LEAF_TYPES]}"
            )
        return copy.deepcopy(value)

    # -- attribute access -----------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__["_frozen"]:
            raise AttributeError(
                f"cannot set '{name}': this CfgNode is frozen (defrost() first)"
            )
        if name in self.__dict__:
            raise AttributeError(f"'{name}' shadows CfgNode internal state")
        self[name] = self._wrap_value(value, (name,))

    # -- printing ---------------------------------------------------------------

    def __str__(self) -> str:
        lines: List[str] = []
        for k in sorted(self):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                body = str(v)
                lines.extend(
                    "  " + line for line in (body.split("\n") if body else [])
                )
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({super().__repr__()})"

    # -- freezing ---------------------------------------------------------------

    def freeze(self) -> None:
        self._propagate_frozen(True)

    def defrost(self) -> None:
        self._propagate_frozen(False)

    def is_frozen(self) -> bool:
        return self.__dict__["_frozen"]

    def _propagate_frozen(self, frozen: bool) -> None:
        self.__dict__["_frozen"] = frozen
        for v in self.values():
            if isinstance(v, CfgNode):
                v._propagate_frozen(frozen)

    # -- cloning / serialization --------------------------------------------------

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict:
        """Plain nested-dict copy of the tree."""
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v)
            for k, v in self.items()
        }

    def dump(self, **kwargs) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), **kwargs)

    # -- merging ----------------------------------------------------------------

    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            self.merge_from_other_cfg(self.load_cfg(f))

    def merge_from_other_cfg(self, cfg_other: "CfgNode") -> None:
        if not isinstance(cfg_other, CfgNode):
            raise TypeError(
                f"can only merge a CfgNode, got {type(cfg_other).__name__}"
            )
        self._merge(cfg_other, ())

    def _merge(self, other: "CfgNode", path: Tuple[str, ...]) -> None:
        """Recursively fold `other` into self. Existing leaves keep their
        type (coercing per _COERCIONS); new keys are adopted unless
        deprecated/renamed."""
        for k, incoming in other.items():
            kpath = path + (str(k),)
            if k in self:
                mine = self[k]
                if isinstance(mine, CfgNode) and isinstance(incoming, CfgNode):
                    mine._merge(incoming, kpath)
                elif isinstance(mine, CfgNode) or isinstance(incoming, CfgNode):
                    raise ValueError(
                        f"cannot merge at '{'.'.join(kpath)}': one side is a "
                        "section, the other a leaf"
                    )
                else:
                    self[k] = _coerce_leaf(incoming, mine, kpath)
            else:
                dotted = ".".join(kpath)
                if self.key_is_deprecated(dotted):
                    continue
                if self.key_is_renamed(dotted):
                    self.raise_key_rename_error(dotted)
                self[k] = self._wrap_value(incoming, kpath)

    def merge_from_list(self, cfg_list: List) -> None:
        """Apply ["a.b", value, ...] overrides onto existing keys."""
        if len(cfg_list) % 2:
            raise ValueError(
                f"override list must alternate key, value — got an odd "
                f"count of {len(cfg_list)} items"
            )
        for dotted, raw in zip(cfg_list[0::2], cfg_list[1::2]):
            if self.key_is_deprecated(dotted):
                continue
            if self.key_is_renamed(dotted):
                self.raise_key_rename_error(dotted)
            node, leaf = self._descend(dotted)
            value = _parse_override(raw)
            node[leaf] = _coerce_leaf(value, node[leaf], tuple(dotted.split(".")))

    def _descend(self, dotted: str) -> Tuple["CfgNode", str]:
        """Walk a dotted path to (owning node, leaf key); the full path must
        already exist."""
        *parents, leaf = dotted.split(".")
        node: CfgNode = self
        walked: List[str] = []
        for part in parents + [leaf]:
            if not isinstance(node, CfgNode) or part not in node:
                raise KeyError(
                    f"override targets unknown config key "
                    f"'{'.'.join(walked + [part])}' (from '{dotted}')"
                )
            walked.append(part)
            if part != leaf or len(walked) < len(parents) + 1:
                node = node[part]
        return node, leaf

    # -- deprecation hooks (API parity; no shipped config uses them) -------------

    def register_deprecated_key(self, key: str) -> None:
        self.__dict__["_deprecated"].add(key)

    def register_renamed_key(
        self, old_name: str, new_name: str, message: Optional[str] = None
    ) -> None:
        self.__dict__["_renamed"][old_name] = (new_name, message)

    def key_is_deprecated(self, full_key: str) -> bool:
        return full_key in self.__dict__["_deprecated"]

    def key_is_renamed(self, full_key: str) -> bool:
        return full_key in self.__dict__["_renamed"]

    def raise_key_rename_error(self, full_key: str) -> None:
        new_name, message = self.__dict__["_renamed"][full_key]
        hint = f" ({message})" if message else ""
        raise KeyError(f"config key '{full_key}' is now '{new_name}'{hint}")

    # -- loading ------------------------------------------------------------------

    @classmethod
    def load_cfg(cls, source) -> "CfgNode":
        """Build a CfgNode from a YAML string or readable file object."""
        import yaml

        if isinstance(source, str):
            text = source
        elif hasattr(source, "read"):
            text = source.read()
        else:
            raise TypeError(
                f"cannot load config from {type(source).__name__}; pass a "
                "YAML string or an open file"
            )
        return cls(yaml.safe_load(text) or {})


def _parse_override(raw: Any) -> Any:
    """Command-line override values arrive as strings; interpret Python
    literals ('1e-4', '[1, 2]', 'True'), leaving plain words as strings."""
    if isinstance(raw, dict):
        return CfgNode(raw)
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _coerce_leaf(incoming: Any, existing: Any, path: Iterable[str]) -> Any:
    """An override must match the existing leaf's type, up to the silent
    casts in _COERCIONS (or anything over an existing None)."""
    if existing is None or type(incoming) is type(existing):
        return incoming
    if _COERCIONS.get(type(incoming)) is type(existing):
        return type(existing)(incoming)
    raise ValueError(
        f"config key '{'.'.join(path)}' holds a {type(existing).__name__} "
        f"({existing!r}) but the override is a {type(incoming).__name__} "
        f"({incoming!r})"
    )


def load_config(path: str) -> CfgNode:
    """Load a reference-format experiment YAML into a CfgNode.

    Equivalent of the reference's inline config load
    (`train_transformed_rays.py:39-42`).
    """
    import yaml

    with open(path, "r") as f:
        return CfgNode(yaml.safe_load(f))

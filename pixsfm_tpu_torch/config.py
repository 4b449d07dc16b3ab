"""Minimal OmegaConf-compatible configuration system.

The reference uses OmegaConf DictConfig trees everywhere (pixsfm/refine_colmap.py:24-37,
configs/*.yaml with ``${..interpolation}`` variable interpolation and CLI dotlists,
refine_colmap.py:198-200). OmegaConf is not available in this environment, so this module
provides a small, dependency-free replacement with the subset of semantics pixsfm relies on:

- ``DictConfig``: attribute + item access, recursive merge, ``to_dict()``.
- ``merge(*confs)``: right-most wins, recursive on dicts.
- ``OmegaConf.from_dotlist``: ``a.b.c=value`` overrides with YAML-typed values.
- Variable interpolation ``${path}`` (absolute) and ``${..path}`` (relative, one ``.`` per
  level up beyond the first), resolved lazily at access time like OmegaConf.

Copy of ``pixsfm_tpu/config.py``; ``yaml`` is imported only where YAML text is
parsed, so the package imports without PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "MISSING",
    "DictConfig",
    "OmegaConf",
    "load_config",
    "merge",
]


class _Missing:
    def __repr__(self):
        return "???"


# OmegaConf's marker of a value the user must set
MISSING = _Missing()


def _parse_value(text: str) -> Any:
    """Parse a scalar CLI value with YAML typing rules."""
    import yaml
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


class DictConfig:
    """A nested attribute-accessible dict with lazy ``${...}`` interpolation."""

    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 parent: Optional["DictConfig"] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_parent", parent)
        if data:
            for k, v in data.items():
                self[k] = v

    # -- container protocol -------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def __len__(self):
        return len(self._data)

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(key)
        return self._resolve(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict):
            value = DictConfig(value, parent=self)
        elif isinstance(value, DictConfig):
            object.__setattr__(value, "_parent", self)
        self._data[key] = value

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self[key] = default
        return self[key]

    def pop(self, key: str, *default) -> Any:
        if key in self._data:
            val = self._resolve(self._data.pop(key))
            return val
        if default:
            return default[0]
        raise KeyError(key)

    def update(self, other: Union[Dict, "DictConfig"]) -> None:
        for k in (other.keys() if isinstance(other, DictConfig) else other):
            self[k] = other[k]

    # -- interpolation ------------------------------------------------------
    def _root(self) -> "DictConfig":
        node = self
        while node._parent is not None:
            node = node._parent
        return node

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, str) and value.startswith("${") and value.endswith("}"):
            path = value[2:-1]
            node: DictConfig
            if path.startswith("."):
                # ``${..a.b}``: first '.' selects self, each further '.' one level up.
                node = self
                i = 1
                while i < len(path) and path[i] == ".":
                    if node._parent is not None:
                        node = node._parent
                    i += 1
                path = path[i:]
            else:
                node = self._root()
            parts = [p for p in path.split(".") if p]

            def lookup(start):
                cur: Any = start
                for part in parts:
                    cur = cur[part]
                return cur

            # Try the addressed node; if the key is absent there, walk up the
            # ancestor chain (lexical-scoping fallback, slightly more forgiving
            # than OmegaConf so partial override trees still resolve).
            while True:
                try:
                    return lookup(node)
                except (KeyError, TypeError):
                    if node._parent is None:
                        raise
                    node = node._parent
        if isinstance(value, list):
            return [self._resolve(v) for v in value]
        return value

    # -- conversion ---------------------------------------------------------
    def to_dict(self, resolve: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, raw in self._data.items():
            v = self._resolve(raw) if resolve else raw
            if isinstance(v, DictConfig):
                out[k] = v.to_dict(resolve=resolve)
            elif isinstance(v, list):
                out[k] = [x.to_dict(resolve=resolve) if isinstance(x, DictConfig)
                          else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "DictConfig":
        return DictConfig(copy.deepcopy(self.to_dict(resolve=False)))

    def __deepcopy__(self, memo):
        return self.copy()

    def __repr__(self):
        return f"DictConfig({self.to_dict(resolve=False)!r})"

    def __eq__(self, other):
        if isinstance(other, DictConfig):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented


def _merge_into(base: DictConfig, other: Union[Dict, DictConfig]) -> DictConfig:
    items = other.items() if isinstance(other, (DictConfig, dict)) else []
    if isinstance(other, DictConfig):
        items = [(k, other._data[k]) for k in other._data]
    elif isinstance(other, dict):
        items = list(other.items())
    for k, v in items:
        if isinstance(v, (dict, DictConfig)):
            cur = base._data.get(k)
            if isinstance(cur, DictConfig) and not (
                    isinstance(v, str)):
                _merge_into(cur, v)
            else:
                base[k] = copy.deepcopy(v.to_dict(resolve=False)
                                        if isinstance(v, DictConfig) else v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def merge(*configs: Union[Dict, DictConfig, None]) -> DictConfig:
    """Recursive right-most-wins merge, like ``OmegaConf.merge``."""
    out = DictConfig()
    for conf in configs:
        if conf is None:
            continue
        _merge_into(out, conf)
    return out


class OmegaConf:
    """API shim matching the subset of omegaconf.OmegaConf pixsfm uses."""

    @staticmethod
    def create(data: Union[Dict, str, None] = None) -> DictConfig:
        """A config from a dict, YAML text or another config (copied)."""
        if data is None:
            return DictConfig()
        if isinstance(data, str):
            import yaml
            return DictConfig(yaml.safe_load(data) or {})
        if isinstance(data, DictConfig):
            return data.copy()
        return DictConfig(copy.deepcopy(data))

    @staticmethod
    def load(path) -> DictConfig:
        import yaml
        with open(path, "r") as f:
            return DictConfig(yaml.safe_load(f) or {})

    @staticmethod
    def merge(*configs) -> DictConfig:
        return merge(*configs)

    @staticmethod
    def from_dotlist(dotlist: List[str]) -> DictConfig:
        conf = DictConfig()
        for item in dotlist:
            if "=" not in item:
                raise ValueError(f"dotlist entry must be key=value: {item!r}")
            key, value = item.split("=", 1)
            node = conf
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node._data[part], DictConfig):
                    node[part] = {}
                node = node._data[part]
            node[parts[-1]] = _parse_value(value)
        return conf

    @staticmethod
    def from_cli(argv: Optional[List[str]] = None) -> DictConfig:
        """The ``key=value`` entries of ``argv`` (default ``sys.argv[1:]``)."""
        if argv is None:
            import sys
            argv = [a for a in sys.argv[1:] if "=" in a]
        return OmegaConf.from_dotlist(argv)

    @staticmethod
    def to_container(conf, resolve: bool = True):
        if isinstance(conf, DictConfig):
            return conf.to_dict(resolve=resolve)
        return conf

    @staticmethod
    def set_struct(conf, flag: bool):  # accepted for API parity; no-op
        return None

    @staticmethod
    def set_readonly(conf, flag: bool):  # accepted for API parity; no-op
        return None


def load_config(name_or_path, extra: Optional[Union[Dict, DictConfig]] = None,
                cli: Optional[List[str]] = None) -> DictConfig:
    """Load a named preset (``configs/<name>.yaml`` of this package) or a YAML path, then
    apply ``extra`` and CLI dotlist overrides."""
    from pathlib import Path

    confs = []
    if name_or_path is not None:
        p = Path(str(name_or_path))
        if not p.exists():
            p = Path(__file__).parent / "configs" / f"{name_or_path}.yaml"
        if not p.exists():
            raise FileNotFoundError(f"config {name_or_path!r} not found")
        confs.append(OmegaConf.load(p))
    if extra is not None:
        confs.append(extra)
    if cli:
        confs.append(OmegaConf.from_dotlist(cli))
    return merge(*confs)

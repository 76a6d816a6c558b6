"""Config system: one typed AttrDict-style config with yaml ingest (port
of ``pgl_tpu/utils/config.py``; ``yaml`` is imported only to read or write
a file).

The reference uses three ad-hoc conventions (``easydict`` yaml in examples,
``AttrDict`` in ``pgl/distributed/helper.py:30``, ``util_config`` in PGLBox)
— here a single ``Config`` covers them: attribute access, nesting, yaml
load/save, dotted-path overrides, and merge.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["Config", "load_config"]


class Config(dict):
    """dict with recursive attribute access; missing keys read as None."""

    def __init__(self, data: Optional[Dict] = None, **kwargs):
        super().__init__()
        for src in (data or {}), kwargs:
            for k, v in src.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict):
            return cls(v)  # always rebuild: containers stay independent
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        return self.get(name)

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def merge(self, other: Dict) -> "Config":
        """Deep merge ``other`` into a copy of self (other wins)."""
        out = Config(self)
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(out.get(k), Config):
                out[k] = out[k].merge(v)
            else:
                out[k] = self._wrap(v)
        return out

    def override(self, dotted: str, value) -> "Config":
        """``cfg.override("model.hidden_size", 128)``."""
        keys = dotted.split(".")
        out = Config(self)
        cur = out
        for k in keys[:-1]:
            if not isinstance(cur.get(k), Config):
                cur[k] = Config()
            cur = cur[k]
        cur[keys[-1]] = self._wrap(value)
        return out

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}

    def save(self, path: str):
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f)


def load_config(path_or_dict) -> Config:
    if isinstance(path_or_dict, dict):
        return Config(path_or_dict)
    import yaml
    with open(path_or_dict) as f:
        return Config(yaml.safe_load(f) or {})

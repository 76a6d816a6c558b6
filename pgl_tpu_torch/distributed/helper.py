"""Distributed config helpers (port of ``pgl_tpu/distributed/helper.py``;
reference: ``pgl/distributed/helper.py``): yaml→AttrDict loading
(``:30``), ``etype2files``/``ntype2files`` parsing (``:99-133``),
reverse-etype expansion, ip list loading. ``yaml`` is imported only when a
config is read from a file: a dict config needs no PyYAML."""

from __future__ import annotations

import os
from typing import Dict, List, Union

__all__ = ["AttrDict", "load_config", "parse_files", "get_all_edge_type",
           "load_ip_addr", "parse_etype", "reverse_etype"]


class AttrDict(dict):
    """dict with attribute access; missing keys read as None
    (matching the reference's lenient config access)."""

    def __getattr__(self, name):
        return self.get(name)

    def __setattr__(self, name, value):
        self[name] = value


def load_config(config: Union[str, dict]) -> AttrDict:
    if isinstance(config, dict):
        return AttrDict(config)
    import yaml
    with open(config) as f:
        return AttrDict(yaml.safe_load(f))


def parse_files(spec: str) -> Dict[str, List[str]]:
    """``"u2e2t:./edges.txt,f2e2t:./e2.txt"`` → {etype: [files...]}."""
    out: Dict[str, List[str]] = {}
    if not spec:
        return out
    for part in str(spec).split(","):
        name, path = part.split(":", 1)
        out.setdefault(name.strip(), []).extend(
            p for p in path.split(";") if p)
    return out


def parse_etype(etype: str):
    """``u2e2t`` → ("u", "t"); plain names map to themselves."""
    pieces = etype.split("2")
    if len(pieces) == 3:
        return pieces[0], pieces[2]
    return etype, etype


def reverse_etype(etype: str) -> str:
    src, dst = parse_etype(etype)
    if "2" in etype and len(etype.split("2")) == 3:
        mid = etype.split("2")[1]
        return f"{dst}2{mid}2{src}"
    return etype


def get_all_edge_type(etype2files: Dict, symmetry: bool) -> List[str]:
    etypes = list(etype2files.keys())
    if symmetry:
        etypes = etypes + [reverse_etype(e) for e in etypes
                           if reverse_etype(e) not in etypes]
    return etypes


def load_ip_addr(ip_config: Union[str, List[str]]) -> List[str]:
    if isinstance(ip_config, (list, tuple)):
        return list(ip_config)
    if os.path.exists(ip_config):
        with open(ip_config) as f:
            return [line.strip() for line in f if line.strip()]
    return [p for p in str(ip_config).split(";") if p]

"""YAML + dotlist-CLI config with OmegaConf-like behaviour.

Copy of `dimo_tpu/io/config.py` (the port keeps its own copy): the same
key names, precedence (CLI wins), dotted-key access and YAML-typed value
parsing. PyYAML is imported inside the functions that parse or write
YAML, so `Config` itself (all the trainer needs) works without it.
"""
from __future__ import annotations

from typing import Any


class Config(dict):
    """dict with attribute access + .get default, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj


def load_yaml(path: str) -> Config:
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config._wrap(data)


def _parse_value(text: str) -> Any:
    import yaml
    return yaml.safe_load(text) if text != "" else None


def apply_dotlist(cfg: Config, dotlist: list[str]) -> Config:
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry must be key=value: {item!r}")
        key, _, raw = item.partition("=")
        key = key.lstrip("-").strip()
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[p] = nxt
            node = nxt
        node[parts[-1]] = _parse_value(raw.strip())
    return cfg


def load_config(yaml_path: str, dotlist: list[str] | None = None) -> Config:
    cfg = load_yaml(yaml_path)
    if dotlist:
        apply_dotlist(cfg, dotlist)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    import yaml

    def unwrap(o):
        if isinstance(o, dict):
            return {k: unwrap(v) for k, v in o.items()}
        if isinstance(o, list):
            return [unwrap(v) for v in o]
        return o
    with open(path, "w") as f:
        yaml.safe_dump(unwrap(cfg), f, sort_keys=False)

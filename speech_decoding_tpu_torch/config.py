"""Config system: YAML + dotted CLI overrides.

Mirrors the reference's Hydra/OmegaConf surface (``python train.py
dataset=Brennan2018 rebuild_dataset=True split_mode=deep``) without the Hydra
dependency [ref: train.py:28, configs/config.yaml:1-54]. The reference mutates
its DictConfig at runtime via ``open_dict`` (root_dir, num_subjects,
preprocs.{x_done,y_done}) [ref: train.py:45-46,62-63]; ``Config`` is openly
writable so the same derived fields exist, but framework code prefers explicit
arguments.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import yaml


class Config(dict):
    """A dict with attribute access and dotted-path get/set. Nested dicts are
    wrapped on insertion, so ``cfg.preprocs.brain_resample_rate`` works."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    # -- dotted paths --------------------------------------------------------
    def select(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def __repr__(self) -> str:
        return "Config(" + json.dumps(self.to_dict(), indent=2, default=str) + ")"


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML semantics (true/1.5/[a,b]/str).
    Scientific notation like 3e-4 is coerced to float (YAML 1.1 treats it as a
    string — the reference works around this with float(args.lr)
    [ref: train.py:162])."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def parse_overrides(argv: List[str]) -> Dict[str, Any]:
    """Parse ``key=value`` / ``nested.key=value`` CLI arguments."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Override must look like key=value, got: {arg!r}")
        key, _, value = arg.partition("=")
        out[key.strip()] = _parse_value(value.strip())
    return out


DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "config.yaml"
)
# the same file shipped as package data (a repo symlink, so it cannot drift):
# non-editable installs have no repo-root configs/ directory
_PACKAGED_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "configs", "config.yaml"
)


def load_config(
    path: Optional[str] = None, overrides: Optional[List[str]] = None
) -> Config:
    """Load the YAML config and apply dotted CLI overrides."""
    path = path or (
        DEFAULT_CONFIG_PATH
        if os.path.exists(DEFAULT_CONFIG_PATH)
        else _PACKAGED_CONFIG_PATH
    )
    with open(path) as f:
        cfg = Config(yaml.safe_load(f))
    for key, value in parse_overrides(overrides or []).items():
        cfg.set_path(key, value)
    return cfg


def default_config() -> Config:
    """The in-repo default config (same schema as the reference's
    configs/config.yaml)."""
    return load_config()


def iter_flat(cfg: Config, prefix: str = "") -> Iterator[tuple]:
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, Config):
            yield from iter_flat(v, key + ".")
        else:
            yield key, v

"""YAML configs as nested ``argparse.Namespace`` objects (the port's own
copy of the JAX package's ``config.py`` surface that the port uses):
``load_yaml_config`` with its ``inherit: {path, key}`` parent splice,
``dict2namespace`` / ``namespace2dict``, the dict-union ``merge_configs``
and ``save_config``."""

from __future__ import annotations

from argparse import Namespace
from pathlib import Path

import yaml


def dict2namespace(data: dict) -> Namespace:
    """Nested dicts -> nested namespaces."""
    return Namespace(**{k: dict2namespace(v) if isinstance(v, dict) else v
                        for k, v in data.items()})


def namespace2dict(ns: Namespace) -> dict:
    """Nested namespaces -> nested dicts."""
    return {k: namespace2dict(v) if isinstance(v, Namespace) else v
            for k, v in vars(ns).items()}


def _as_dict(conf) -> dict:
    return conf if isinstance(conf, dict) else vars(conf)


def merge_configs(old_conf, new_conf) -> Namespace:
    """Dict-union of the top-level keys; keys of ``new_conf`` win."""
    return Namespace(**{**_as_dict(old_conf), **_as_dict(new_conf)})


def load_yaml_config(cfg_path):
    """A YAML file -> (namespace, dict).  An ``inherit: {path, key}`` entry
    splices in the parent file (or its ``key`` section) under the child's
    keys, the path relative to the child."""
    cfg_path = Path(cfg_path)
    config = yaml.safe_load(cfg_path.read_text())
    if "inherit" in config:
        inherit = config.pop("inherit")
        parent = yaml.safe_load((cfg_path.parent / inherit["path"]).read_text())
        if "key" in inherit:
            parent = parent[inherit["key"]]
        config = {**parent, **config}
    return dict2namespace(config), config


def save_config(cfg_path, config) -> None:
    if isinstance(config, Namespace):
        config = namespace2dict(config)
    Path(cfg_path).write_text(yaml.dump(config))

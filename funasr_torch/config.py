"""Config loading: YAML + deep merge, in the reference config shape (copy of
funasr_tpu/config.py; reference funasr/bin/train.py:40,
funasr/download/download_model_from_hub.py:8).

A config is a plain dict with the reference's keys (``model``,
``model_conf``, ``encoder``, ``encoder_conf``, ...), so reference
``config.yaml`` files load unchanged.  ``yaml`` is imported only when a YAML
file is read: a config given as a dict needs no YAML package.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Mapping, Optional


def deep_update(base: Dict[str, Any], new: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``new`` into ``base`` (in place), returning ``base``:
    nested non-empty mappings merge, everything else overwrites (an empty
    mapping clears the section), as the reference's ``deep_update``
    (funasr/utils/misc.py)."""
    for k, v in new.items():
        if isinstance(v, Mapping) and v and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def load_config(model_dir_or_yaml: Optional[str] = None, **overrides: Any) -> Dict[str, Any]:
    """Resolve a model config: a directory holding ``config.yaml`` (the model
    hub layout; ``configuration.json``'s ``file_path_metas`` become paths) or
    a YAML file; ``overrides`` deep-merge on top, as hydra ``++key=value``
    overrides do in the reference."""
    cfg: Dict[str, Any] = {}
    if model_dir_or_yaml is not None:
        path = model_dir_or_yaml
        if os.path.isdir(path):
            yaml_path = os.path.join(path, "config.yaml")
            if os.path.exists(yaml_path):
                cfg = load_yaml(yaml_path)
            cfg["model_path"] = path
            meta_path = os.path.join(path, "configuration.json")
            if os.path.exists(meta_path):
                with open(meta_path, "r", encoding="utf-8") as f:
                    meta = json.load(f)
                for key, rel in (meta.get("file_path_metas") or {}).items():
                    if isinstance(rel, str):
                        cfg[key] = os.path.join(path, rel)
        elif os.path.isfile(path):
            cfg = load_yaml(path)
        else:
            raise FileNotFoundError(f"no such config: {path}")
    deep_update(cfg, overrides)
    return cfg


def component_conf(cfg: Mapping[str, Any], key: str) -> Dict[str, Any]:
    """The ``<key>_conf`` dict of a component key (empty when absent)."""
    return dict(cfg.get(f"{key}_conf") or {})

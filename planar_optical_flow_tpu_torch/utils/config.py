"""Config loading with the JAX package's conventions.

Counterpart of ``planar_optical_flow_tpu/utils/config.py``:
``load_config(path, tag=...)`` reads a config tree and sets
``cfg["name"] = <basename>_<tag>`` (the config's own ``tag`` wins over the
argument).

A ``.json`` file is read with :mod:`json`. JSON is a subset of YAML, so the
JAX loader's ``yaml.safe_load`` returns the same dict for it. PyYAML is
imported only when a ``.yaml``/``.yml`` file is read: the port's runtime
does not need it, and where it is missing the config can be passed as JSON.
"""

from __future__ import annotations

import json
import os


def _read_yaml(path: str):
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs PyYAML, which is not installed; pass the "
            "config as JSON instead (the same tree, e.g. written with "
            "json.dump)") from e
    with open(path) as f:
        return yaml.safe_load(f)


def load_config(path: str, tag: str = "") -> dict:
    path = os.fspath(path)
    if path.lower().endswith(".json"):
        with open(path) as f:
            cfg = json.load(f)
    else:
        cfg = _read_yaml(path)
    base = os.path.basename(path)
    base = base[: base.rfind(".")] if "." in base else base
    explicit = cfg.get("tag") or tag
    cfg["name"] = f"{base}_{explicit}" if explicit else base
    return cfg

"""User configuration (counterpart of `gammagl_tpu/data/config.py`):
the same per-user ``~/.ggl_tpu/config.json`` and the same
``GGL_TPU_DATASET_ROOT`` override, so both packages find one dataset
root."""

import json
import os
import os.path as osp

__all__ = ["get_config", "get_dataset_root", "save_config", "DEFAULTS"]

DEFAULTS = {
    "dataset_root": "~/.ggl_tpu/datasets",
    "mesh_axis_names": ["dp"],
    "use_pallas": True,
}

_CONFIG_DIR = osp.expanduser("~/.ggl_tpu")
_CONFIG_PATH = osp.join(_CONFIG_DIR, "config.json")
_cache = None


def get_config():
    """DEFAULTS, updated from the config file, then from the environment
    (``GGL_TPU_DATASET_ROOT``); read once and cached."""
    global _cache
    if _cache is not None:
        return _cache
    cfg = dict(DEFAULTS)
    if osp.exists(_CONFIG_PATH):
        try:
            with open(_CONFIG_PATH) as f:
                cfg.update(json.load(f))
        except (json.JSONDecodeError, OSError):
            pass
    if "GGL_TPU_DATASET_ROOT" in os.environ:
        cfg["dataset_root"] = os.environ["GGL_TPU_DATASET_ROOT"]
    _cache = cfg
    return cfg


def get_dataset_root():
    return osp.expanduser(get_config()["dataset_root"])


def save_config(cfg):
    """Write ``cfg`` to the config file; the next `get_config` reads it."""
    global _cache
    os.makedirs(_CONFIG_DIR, exist_ok=True)
    with open(_CONFIG_PATH, "w") as f:
        json.dump(cfg, f, indent=2)
    _cache = None

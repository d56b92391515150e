"""Declarative Serve deployment from a config file.

Reference: the Serve CLI (``python/ray/serve/scripts.py`` — ``serve
deploy/run/status/shutdown`` against a YAML of applications with
``import_path`` targets, ``serve/schema.py`` ServeDeploySchema). Same
shape here::

    applications:
      - name: summarizer
        route_prefix: /sum
        import_path: my_pkg.app:app        # module:attr -> Application
        args: {model: "small"}             # passed to the builder if
                                           # import_path names a function
      - name: translator
        route_prefix: /translate
        import_path: my_pkg.apps.translate
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List


def _import_target(import_path: str):
    """``module.sub:attr`` (or ``module.sub.attr``) -> python object."""
    if ":" in import_path:
        mod_name, _, attr = import_path.partition(":")
    else:
        mod_name, _, attr = import_path.rpartition(".")
    if not mod_name:
        raise ValueError(f"bad import_path {import_path!r}")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise ValueError(
            f"{mod_name!r} has no attribute {attr!r} "
            f"(import_path {import_path!r})")


def load_config(path_or_dict) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        cfg = path_or_dict
    else:
        import yaml

        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f) or {}
    apps = cfg.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("serve config needs a non-empty 'applications' "
                         "list")
    for app in apps:
        if "import_path" not in app:
            raise ValueError(f"application {app.get('name')!r} needs an "
                             "import_path")
    return cfg


def deploy_config(path_or_dict) -> List[str]:
    """Deploy every application in the config; returns their names."""
    from ray_tpu_torch import serve

    cfg = load_config(path_or_dict)
    deployed = []
    for app_cfg in cfg["applications"]:
        target = _import_target(app_cfg["import_path"])
        args = app_cfg.get("args") or {}
        # A builder function takes args and returns a bound Application;
        # a bound Application deploys directly (reference semantics).
        if callable(target) and not hasattr(target, "deployment"):
            target = target(**args) if args else target()
        name = app_cfg.get("name", "default")
        serve.run(target, name=name,
                  route_prefix=app_cfg.get("route_prefix", "/"))
        deployed.append(name)
    return deployed

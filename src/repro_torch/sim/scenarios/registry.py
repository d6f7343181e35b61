"""Named scenario registry: config class + builder per workload family.

Counterpart of ``repro/sim/scenarios/registry.py``.  A scenario is a
frozen config dataclass plus a builder that turns it into a schema-valid
:class:`~repro_torch.sim.scenarios.schema.Trace`; the config class is the
dispatch key, so ``SimConfig.workload`` finds its builder.  Built-in
families load lazily on first lookup.  Ported so far: ``"google"``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.sim.scenarios.schema import Trace

__all__ = ["ScenarioSpec", "register", "build_trace"]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    config_cls: type
    build: Callable[[Any], Trace]
    doc: str = ""


_SCENARIOS: dict[str, ScenarioSpec] = {}
_BY_CONFIG: dict[type, ScenarioSpec] = {}

# name -> module that registers it on import (lazy: the workload module
# itself imports this one)
_BUILTIN = {
    "google": "repro_torch.sim.workload",
}


def register(name: str, config_cls: type, doc: str = ""):
    """Decorator for a ``build(cfg) -> Trace`` function."""
    def deco(build_fn):
        spec = ScenarioSpec(name=name, config_cls=config_cls,
                            build=build_fn, doc=doc)
        _SCENARIOS[name] = spec
        _BY_CONFIG[config_cls] = spec
        return build_fn
    return deco


def _load_builtins() -> None:
    for mod in set(_BUILTIN.values()):
        importlib.import_module(mod)


def build_trace(cfg: Any) -> Trace:
    """Dispatch a scenario config to its registered builder."""
    spec = _BY_CONFIG.get(type(cfg))
    if spec is None:
        _load_builtins()
        spec = _BY_CONFIG.get(type(cfg))
    if spec is None:
        raise TypeError(f"{type(cfg).__name__} is not a registered scenario "
                        f"config (registered: {tuple(sorted(_SCENARIOS))})")
    return spec.build(cfg)

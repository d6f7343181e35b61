"""Named scenario registry: config class + builder per workload family.

Counterpart of ``repro/sim/scenarios/registry.py``, with the same API.
Families: ``google``, ``diurnal``, ``flashcrowd``, ``heavytail``,
``colocated``, ``replay``, ``fitted`` and ``stream`` (any of the others
in a bounded device window).

A *scenario* is a frozen config dataclass plus a build function that turns it
into a schema-valid :class:`~repro_torch.sim.scenarios.schema.Trace`.  Sources
register under a short name::

    @register("diurnal", DiurnalConfig, doc="tidal day/night service load")
    def build(cfg: DiurnalConfig) -> Trace: ...

and the sweep's ``scenario`` grid axis, ``make_config`` and
``build_trace`` dispatch through the registry.  Config classes double as
the dispatch key, so ``SimConfig.workload`` can hold ANY registered
scenario config and ``run_sim`` still finds the right build function.

Built-in families load lazily: looking up a name (or a config type)
that is not registered yet first imports the module known to provide
it, so ``make_config("google")`` works without the caller importing
``repro_torch.sim.workload`` explicitly.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.sim.scenarios.schema import Trace

__all__ = ["ScenarioSpec", "register", "get", "scenario_names",
           "scenario_of", "make_config", "build_trace"]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    config_cls: type
    build: Callable[[Any], Trace]
    doc: str = ""


_SCENARIOS: dict[str, ScenarioSpec] = {}
_BY_CONFIG: dict[type, ScenarioSpec] = {}

# name -> module that registers it on import (lazy, avoids import cycles:
# repro_torch.sim.workload itself imports this module)
_BUILTIN = {
    "google": "repro_torch.sim.workload",
    "diurnal": "repro_torch.sim.scenarios.families",
    "flashcrowd": "repro_torch.sim.scenarios.families",
    "heavytail": "repro_torch.sim.scenarios.families",
    "colocated": "repro_torch.sim.scenarios.families",
    "replay": "repro_torch.sim.scenarios.replay",
    "fitted": "repro_torch.sim.scenarios.fitting",
    "stream": "repro_torch.sim.scenarios.stream",
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


def get(name: str) -> ScenarioSpec:
    if name not in _SCENARIOS and name in _BUILTIN:
        importlib.import_module(_BUILTIN[name])
    try:
        return _SCENARIOS[name]
    except KeyError:
        _load_builtins()
        if name in _SCENARIOS:
            return _SCENARIOS[name]
        raise KeyError(f"unknown scenario {name!r} "
                       f"(registered: {scenario_names()})") from None


def scenario_names() -> tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_SCENARIOS))


def scenario_of(cfg: Any) -> str:
    """Registry name of a scenario config instance."""
    return _spec_for(cfg).name


def _spec_for(cfg: Any) -> ScenarioSpec:
    spec = _BY_CONFIG.get(type(cfg))
    if spec is None:
        _load_builtins()
        spec = _BY_CONFIG.get(type(cfg))
    if spec is None:
        raise TypeError(f"{type(cfg).__name__} is not a registered "
                        f"scenario config (registered: {scenario_names()})")
    return spec


# the only fields that carry across FAMILIES when the sweep's scenario
# axis swaps workloads: grid scale, seed and the tenant layout.  Shape
# parameters (runtime ranges, demand ranges, mix fractions) stay
# family-authentic — carrying a CI-scale google max_runtime into
# `diurnal` would erase its day-cycle character.  Tenancy carries
# because it is population structure, not load shape: a sweep pairing a
# `tenancy` axis with a `scenario` axis keeps the same tenant mix.
_CARRY = ("n_apps", "max_components", "seed", "n_tenants", "tenant_skew")


def make_config(name: str, base: Any = None, **overrides: Any):
    """Build the named scenario's config.

    ``base`` may be any other scenario config.  Same family: ``base`` is
    kept verbatim (plus ``overrides``).  Different family: only the
    shared scale knobs (``n_apps``, ``max_components``, ``seed``) carry
    over — this is how the sweep's ``scenario`` axis preserves the grid's
    scale while switching regimes.  ``overrides`` always win.
    """
    spec = get(name)
    kw: dict[str, Any] = {}
    if base is not None and type(base) is spec.config_cls:
        kw = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base)}
    elif base is not None:
        ours = {f.name for f in dataclasses.fields(spec.config_cls)}
        base_fields = {f.name for f in dataclasses.fields(base)}
        for fname in _CARRY:
            if fname in ours and fname in base_fields:
                kw[fname] = getattr(base, fname)
    kw.update(overrides)
    return spec.config_cls(**kw)


def build_trace(cfg: Any) -> Trace:
    """Dispatch a scenario config to its registered build function."""
    return _spec_for(cfg).build(cfg)

"""Workload sources for the simulator (counterpart of
``repro.sim.scenarios``): the canonical :class:`Trace` schema and the
scenario registry.  Ported families: ``google``."""
from repro_torch.sim.scenarios.registry import (ScenarioSpec, build_trace,
                                                register)
from repro_torch.sim.scenarios.schema import (SEGMENTS, SLO_CLASSES, Trace,
                                              TraceValidationError)

__all__ = ["SEGMENTS", "SLO_CLASSES", "Trace", "TraceValidationError",
           "ScenarioSpec", "register", "build_trace"]

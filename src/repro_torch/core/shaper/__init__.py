"""Resource shaper (paper §3.2): shaping policies + safe-guard buffer."""
from repro_torch.core.shaper.baseline import baseline_shape
from repro_torch.core.shaper.optimistic import optimistic_shape
from repro_torch.core.shaper.pessimistic import (ShapeDecision, ShapeProblem,
                                                 pessimistic_shape)
from repro_torch.core.shaper.safeguard import (SafeguardConfig, beta,
                                               shaped_demand, shaped_demand_scaled)

POLICIES = {
    "baseline": baseline_shape,
    "optimistic": optimistic_shape,
    "pessimistic": pessimistic_shape,
}

__all__ = ["ShapeProblem", "ShapeDecision", "pessimistic_shape",
           "optimistic_shape", "baseline_shape", "POLICIES",
           "SafeguardConfig", "beta", "shaped_demand", "shaped_demand_scaled"]

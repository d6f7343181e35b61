"""Trace-driven discrete-event cluster simulator (paper §4), ported."""
from repro_torch.sim.cluster import Cluster, ClusterConfig
from repro_torch.sim.engine import SimConfig, run_sim
from repro_torch.sim.metrics import SimResults
from repro_torch.sim.workload import Trace, Workload, WorkloadConfig, generate

__all__ = ["Cluster", "ClusterConfig", "SimConfig", "run_sim", "SimResults",
           "Trace", "Workload", "WorkloadConfig", "generate"]

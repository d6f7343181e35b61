"""Trace-driven discrete-event cluster simulator (paper §4), ported: the
host engine (``run_sim``) and the device engine (``run_sim_scan``,
``run_cohort_scan``)."""
from repro_torch.sim.cluster import Cluster, ClusterConfig
from repro_torch.sim.engine import SimConfig, run_sim
from repro_torch.sim.metrics import SimResults
from repro_torch.sim.step import run_cohort_scan, run_sim_scan
from repro_torch.sim.workload import Trace, Workload, WorkloadConfig, generate

__all__ = ["Cluster", "ClusterConfig", "SimConfig", "run_sim", "run_sim_scan",
           "run_cohort_scan", "SimResults", "Trace", "Workload", "WorkloadConfig",
           "generate"]

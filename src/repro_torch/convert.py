"""Carry a simulation's state from the reference into the port.

The GP has no pretrained weights — its hyper-parameters are fitted at
every tick — so a run's whole state is its configuration and its trace:

  * :func:`sim_config_from_dict` takes ``dataclasses.asdict`` of a
    reference ``SimConfig``;
  * :func:`trace_from_arrays` takes the numpy columns of a reference
    ``Trace``.

Both take plain Python and numpy values only, so this module needs
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.forecast import GPConfig
from repro_torch.core.shaper import SafeguardConfig
from repro_torch.sim.cluster import ClusterConfig
from repro_torch.sim.engine import SimConfig, Switch
from repro_torch.sim.scenarios.schema import Trace
from repro_torch.sim.workload import WorkloadConfig

_SCALARS = ("policy", "forecaster", "window", "grace", "horizon", "max_ticks",
            "work_lost_on_kill", "leap", "forecast_bucket")


def sim_config_from_dict(d: dict) -> SimConfig:
    """The port's ``SimConfig`` for ``dataclasses.asdict(reference_cfg)``.

    Refuses a config whose calibration or control plane is enabled (not
    ported yet).  Drops ``gp.impl`` (the port dispatches on the device)
    and the ARIMA settings (the ARIMA forecaster is not ported; choosing
    it makes ``run_sim`` raise).  The workload must be the ``google``
    family's config."""
    for block in ("calibration", "control"):
        if d[block]["enabled"]:
            raise NotImplementedError(f"{block}.enabled is not ported yet")
    gp = {k: v for k, v in d["gp"].items() if k != "impl"}
    return SimConfig(
        cluster=ClusterConfig(**d["cluster"]),
        workload=WorkloadConfig(**d["workload"]),
        safeguard=SafeguardConfig(**d["safeguard"]),
        obs=Switch(enabled=d["obs"]["enabled"]),
        gp=GPConfig(**gp),
        **{k: d[k] for k in _SCALARS})


def trace_from_arrays(**cols: np.ndarray) -> Trace:
    """A validated port ``Trace`` from the reference trace's columns
    (``submit``, ``is_elastic``, ..., ``levels``, ``tenant``, ``slo``),
    copied so the two traces share no memory."""
    names = {f.name for f in dataclasses.fields(Trace)} - {"cfg"}
    unknown = set(cols) - names
    if unknown:
        raise TypeError(f"unknown trace columns: {sorted(unknown)}")
    return Trace(**{k: np.array(v, copy=True) for k, v in cols.items()}).validate()

"""Carry a simulation's state, or a model's parameters, from the
reference into the port.

The GP has no pretrained weights — its hyper-parameters are fitted at
every tick — so a run's whole state is its configuration and its trace:

  * :func:`sim_config_from_dict` takes ``dataclasses.asdict`` of a
    reference ``SimConfig`` and the name of its workload's family;
  * :func:`trace_from_arrays` takes the numpy columns of a reference
    ``Trace``.

The device engine starts from a state, which a test can take from a
reference run:

  * :func:`device_trace_from_arrays`, :func:`sim_state_from_arrays`,
    :func:`calib_state_from_arrays`, :func:`tenant_state_from_arrays` and
    :func:`obs_state_from_arrays` take the fields of the reference's
    ``DeviceTrace``, ``SimState``, ``CalibState``, ``TenantState`` and
    ``ObsState`` as numpy arrays
    (``jax.tree.map(np.asarray, ...)``).

A Whisper model's state is its parameters:

  * :func:`whisper_params_from_arrays` takes the reference's
    ``init_whisper`` pytree as nested dicts of numpy arrays.

All take plain Python and numpy values only, so this module needs
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.control import TenancyConfig, TenantState
from repro_torch.core.forecast import ARIMAConfig, GPConfig
from repro_torch.core.shaper import SafeguardConfig
from repro_torch.core.uncertainty import CalibrationConfig, CalibState
from repro_torch.core.uncertainty.online import GROUP_TIER
from repro_torch.device import resolve_device
from repro_torch.sim.cluster import ClusterConfig
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.rings import ObsState
from repro_torch.sim.engine import SimConfig
from repro_torch.sim import scenarios
from repro_torch.sim.scenarios.schema import Trace
from repro_torch.sim.state import DeviceTrace, SimState

_SCALARS = ("policy", "forecaster", "window", "grace", "horizon", "max_ticks",
            "work_lost_on_kill", "leap", "forecast_bucket")


def _workload_from_dict(d: dict, name: str, inner: str | None):
    if name == "stream":
        if inner is None:
            raise ValueError("workload='stream' needs inner=<the streamed config's family>")
        return scenarios.get(name).config_cls(
            inner=_workload_from_dict(d["inner"], inner, None), window=d["window"],
            seed=d["seed"])
    wl = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return scenarios.get(name).config_cls(**wl)


def sim_config_from_dict(d: dict, *, workload: str = "google",
                         inner: str | None = None) -> SimConfig:
    """The port's ``SimConfig`` for ``dataclasses.asdict(reference_cfg)``.

    Drops ``gp.impl`` (the port dispatches on the device).
    ``asdict`` keeps no type, so
    ``workload`` names the scenario family of ``d["workload"]``: any
    registered one (``google``, ``diurnal``, ``flashcrowd``,
    ``heavytail``, ``colocated``, ``replay``, ``fitted``, ``stream``);
    for ``stream``, ``inner`` names the family of the streamed config.  A
    list in it (a ``FittedConfig``'s ``comp_weights`` read back from
    JSON) becomes the tuple the frozen config hashes by."""
    gp = {k: v for k, v in d["gp"].items() if k != "impl"}
    return SimConfig(
        cluster=ClusterConfig(**d["cluster"]),
        workload=_workload_from_dict(d["workload"], workload, inner),
        safeguard=SafeguardConfig(**d["safeguard"]),
        calibration=CalibrationConfig(**d["calibration"]),
        control=TenancyConfig(**d["control"]),
        obs=ObsConfig(**d["obs"]),
        gp=GPConfig(**gp), arima=ARIMAConfig(**d["arima"]),
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


def _stacked(cls, fields: dict, device, solo: bool, skip=(), optional=()) -> dict:
    """``cls``'s tensor fields from numpy arrays on ``device`` (float32,
    int32 or bool, as the port keeps them), with a leading member axis
    added to a solo run's arrays; the ``optional`` fields may be left
    out."""
    names = {f.name for f in dataclasses.fields(cls)} - set(skip)
    names -= set(optional) - set(fields)
    missing, extra = names - set(fields), set(fields) - names
    if missing or extra:
        raise KeyError(f"{cls.__name__} fields: missing {sorted(missing)}, "
                       f"left over {sorted(extra)}")
    out = {}
    for name in names:
        a = np.asarray(fields[name])
        dt = (bool if a.dtype == bool else np.int32 if a.dtype.kind in "iu"
              else np.float32)
        t = torch.from_numpy(np.array(a, dtype=dt, copy=True))
        out[name] = (t[None] if solo else t).to(device)
    return out


def device_trace_from_arrays(*, device="cuda", **fields) -> DeviceTrace:
    """The port's ``DeviceTrace`` for the reference's (``submit``,
    ``runtime``, ..., ``gid``), solo (N, ...) or stacked (S, N, ...)."""
    return DeviceTrace(**_stacked(DeviceTrace, fields, resolve_device(device),
                                  solo=np.ndim(fields.get("submit")) == 1))


def calib_state_from_arrays(*, device="cuda", **fields) -> CalibState:
    """The port's ``CalibState`` for the reference's fields, solo
    (``pool_count`` a scalar) or stacked.  The per-group tier (the
    ``group_*`` fields) is all there or all None."""
    fields = {k: v for k, v in fields.items() if v is not None}
    tier = [name for name in GROUP_TIER if name in fields]
    if tier and len(tier) != len(GROUP_TIER):
        raise ValueError(f"CalibState's per-group tier is {GROUP_TIER}, all or none; "
                         f"got {tier}")
    return CalibState(**_stacked(CalibState, fields, resolve_device(device),
                                 solo=np.ndim(fields.get("pool_count")) == 0,
                                 optional=GROUP_TIER))


def tenant_state_from_arrays(*, device="cuda", **fields) -> TenantState:
    """The port's ``TenantState`` for the reference's fields (``credit``,
    ``admitted``, ...), solo (T,) or stacked (S, T)."""
    return TenantState(**_stacked(TenantState, fields, resolve_device(device),
                                  solo=np.ndim(fields.get("credit")) == 1))


def obs_state_from_arrays(*, device="cuda", **fields) -> ObsState:
    """The port's ``ObsState`` for the reference's fields (``cursor``,
    ``f32``, ``i32`` and ``lead``, None off leap), solo (``cursor`` a
    scalar) or stacked."""
    fields = {k: v for k, v in fields.items() if v is not None}
    return ObsState(**_stacked(ObsState, fields, resolve_device(device),
                               solo=np.ndim(fields.get("cursor")) == 0, optional=("lead",)))


def sim_state_from_arrays(*, device="cuda", **fields) -> SimState:
    """The port's ``SimState`` for the reference's fields, solo (``t`` a
    scalar) or stacked; ``calib``, ``tenancy`` and ``obs`` are None or
    dicts of the reference's ``CalibState``, ``TenantState`` and
    ``ObsState`` fields."""
    obs = fields.pop("obs", None)
    if obs is not None:
        obs = obs_state_from_arrays(device=device, **obs)
    calib = fields.pop("calib", None)
    if calib is not None:
        calib = calib_state_from_arrays(device=device, **calib)
    tenancy = fields.pop("tenancy", None)
    if tenancy is not None:
        tenancy = tenant_state_from_arrays(device=device, **tenancy)
    return SimState(**_stacked(SimState, fields, resolve_device(device),
                               solo=np.ndim(fields.get("t")) == 0,
                               skip=("calib", "tenancy", "obs")), calib=calib,
                    tenancy=tenancy, obs=obs)


_LN = ("scale", "bias")
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("up", "down")
_ENC_BLOCK = {"ln1": _LN, "attn": _ATTN, "ln2": _LN, "mlp": _MLP}
_DEC_BLOCK = {"ln1": _LN, "self_attn": _ATTN, "ln_x": _LN, "cross_attn": _ATTN,
              "ln2": _LN, "mlp": _MLP}
_WHISPER = {"enc_blocks": _ENC_BLOCK, "enc_ln": _LN, "tok_embed": None,
            "dec_blocks": _DEC_BLOCK, "dec_ln": _LN, "lm_head": None}


def _leaf_paths(schema, prefix=()):
    if schema is None:
        return [prefix]
    if isinstance(schema, tuple):
        return [prefix + (k,) for k in schema]
    return [p for k, sub in schema.items() for p in _leaf_paths(sub, prefix + (k,))]


def _tree_paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, sub in tree.items():
        out.update(_tree_paths(sub, prefix + (k,)))
    return out


def _to_tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (numpy
    has no bfloat16 of its own) go through their 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def whisper_params_from_arrays(tree: dict, *, device="cuda") -> dict:
    """The port's Whisper parameters for the reference's ``init_whisper``
    pytree given as nested dicts of numpy arrays (``jax.tree.map(
    np.asarray, params)``).

    Block leaves carry a leading layer axis, which is unstacked into a
    list of per-layer dicts.  Dtypes are kept.  Raises on a leaf that is
    missing or left over."""
    dev = resolve_device(device)
    got = _tree_paths(tree)
    want = _leaf_paths(_WHISPER)
    missing = [".".join(p) for p in want if p not in got]
    extra = [".".join(p) for p in got if p not in set(want)]
    if missing or extra:
        raise KeyError(f"Whisper parameters: missing {missing}, left over {extra}")
    out: dict = {}
    for path in want:
        t = _to_tensor(got[path], dev)
        if path[0] in ("enc_blocks", "dec_blocks"):
            blocks = out.setdefault(path[0], [{} for _ in range(t.shape[0])])
            if len(blocks) != t.shape[0]:
                raise ValueError(f"{'.'.join(path)} has {t.shape[0]} layers, "
                                 f"other {path[0]} leaves {len(blocks)}")
            for layer, d in zip(t.unbind(0), blocks):
                d.setdefault(path[1], {})[path[2]] = layer.contiguous()
        elif len(path) == 1:
            out[path[0]] = t
        else:
            out.setdefault(path[0], {})[path[1]] = t
    return out

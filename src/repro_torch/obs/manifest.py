"""Run manifests: make every BENCH_*.json reproducible from a sidecar.

A manifest records everything needed to re-run (and trust) a sweep:
canonical hashes of the base config and every expanded cell, the
torch and CUDA versions and the cards that executed it, compile-time
and wall-clock metrics, and the artifact paths it produced.  Cell
hashes are RECOMPUTABLE from the manifest alone (base snapshot +
per-cell overrides + seed), so :func:`load_manifest` can verify a
manifest round-trips its own hashes — a tampered or stale manifest
fails loudly.

A copy of ``repro/obs/manifest.py``; the environment block names torch,
CUDA and the card in place of jax and jaxlib.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import sys

__all__ = ["config_hash", "cell_hash", "build_manifest",
           "write_manifest", "load_manifest"]

MANIFEST_SCHEMA = 1


def _canon(obj) -> str:
    """Canonical JSON: sorted keys, no whitespace, str() fallback for
    exotic leaves (dtypes etc.) — stable across processes."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def config_hash(cfg) -> str:
    """sha256 of the canonical JSON form of a config (dataclass or
    plain dict)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    return hashlib.sha256(_canon(cfg).encode()).hexdigest()


def cell_hash(base_hash: str, overrides: dict, seed: int) -> str:
    """Hash of one expanded sweep cell: the base identity plus exactly
    what the grid changed.  Recomputable from manifest contents."""
    payload = {"base": base_hash, "overrides": dict(overrides),
               "seed": int(seed)}
    return hashlib.sha256(_canon(payload).encode()).hexdigest()


def _environment() -> dict:
    env = {"python": sys.version.split()[0],
           "platform": platform.platform()}
    try:
        import torch
        env["torch"] = torch.__version__
        env["cuda"] = torch.version.cuda
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        env["backend"] = "gpu" if n else "cpu"
        env["device_count"] = n
        env["devices"] = [torch.cuda.get_device_name(i) for i in range(min(n, 16))]
    except Exception as e:  # no torch in a stripped environment
        env["torch"] = f"unavailable: {e}"
    return env


def build_manifest(*, base_config: dict, cells: list[dict],
                   engine: str, artifacts: dict,
                   wall_s: float | None = None,
                   metrics: dict | None = None,
                   extra: dict | None = None) -> dict:
    """Assemble a manifest document.

    ``base_config`` is the asdict snapshot of the sweep base config;
    ``cells`` are dicts with at least ``overrides`` and ``seed`` (a
    ``config_hash`` field is filled in for each).  Both are normalized
    through a JSON round trip BEFORE hashing, so the stored hashes are
    recomputable from the loaded manifest (tuples become lists, exotic
    leaves their str() form — identically on both sides).
    """
    base_config = json.loads(_canon(base_config))
    base_h = config_hash(base_config)
    out_cells = []
    for c in cells:
        c = json.loads(_canon(dict(c)))
        c["config_hash"] = cell_hash(base_h, c.get("overrides", {}),
                                     c.get("seed", 0))
        out_cells.append(c)
    man = {
        "schema": MANIFEST_SCHEMA,
        "engine": engine,
        "base_config": base_config,
        "base_config_hash": base_h,
        "cells": out_cells,
        "environment": _environment(),
        "artifacts": dict(artifacts),
    }
    if wall_s is not None:
        man["wall_s"] = float(wall_s)
    if metrics is not None:
        man["metrics"] = metrics
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, manifest: dict) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=str)
        f.write("\n")


def load_manifest(path: str, verify: bool = True) -> dict:
    """Load a manifest; with ``verify`` (default) recompute the base and
    cell hashes from the stored snapshot/overrides and raise
    ``ValueError`` on any mismatch."""
    with open(path) as f:
        man = json.load(f)
    if verify:
        base_h = config_hash(man["base_config"])
        if base_h != man["base_config_hash"]:
            raise ValueError(
                f"manifest base_config_hash mismatch: stored "
                f"{man['base_config_hash'][:12]}…, recomputed {base_h[:12]}…")
        for c in man.get("cells", []):
            h = cell_hash(base_h, c.get("overrides", {}), c.get("seed", 0))
            if h != c.get("config_hash"):
                raise ValueError(
                    f"manifest cell hash mismatch for "
                    f"{c.get('name', '?')!r}")
    return man

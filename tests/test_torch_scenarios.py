"""The port's scenario families and trace replay
(``repro_torch.sim.scenarios``) against the reference's
(``repro.sim.scenarios``), on the CPU.

The generators are numpy on both sides and make the same draws in the same
order, so each trace is compared column by column for equality, dtypes
included.  Replay mirrors what the reference's code does, also where its
own property tests ask for something else (``tests/test_replay_scale.py``:
dense tenant codes, a padded width that survives the round trip): those
cases are held equal to the reference, not to the property.  One small
flashcrowd run through both device engines end to end is in
``tests/test_torch_step.py``, beside the runs whose compiled reference
program it shares.
"""
import dataclasses
import os
from pathlib import Path

import jax  # noqa: F401  (every port test file imports both frameworks)
import numpy as np
import pytest

from repro.sim import SimConfig
from repro.sim.scenarios import families as rfam
from repro.sim.scenarios import registry as rreg
from repro.sim.scenarios import replay as rrep
from repro_torch import convert
from repro_torch.sim.scenarios import families as tfam
from repro_torch.sim.scenarios import registry as treg
from repro_torch.sim.scenarios import replay as trep
from repro_torch.sim.scenarios.schema import Trace

DATA = Path(__file__).resolve().parent / "data"
FAMILIES = ("diurnal", "flashcrowd", "heavytail", "colocated")
FIXTURES = (("alibaba_tiny.csv", "alibaba"), ("azure_tiny.csv", "azure"))
COLUMNS = [f.name for f in dataclasses.fields(Trace) if f.name != "cfg"]


def _port_cfg(name: str, ref_cfg):
    """The port's config of the same family and fields."""
    return treg.get(name).config_cls(**dataclasses.asdict(ref_cfg))


def _assert_same_trace(got, want):
    for k in COLUMNS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_trace_equals_reference(name):
    """Two seeds at 60 apps, and the configs' fields themselves."""
    assert ([f.name for f in dataclasses.fields(treg.get(name).config_cls)]
            == [f.name for f in dataclasses.fields(rreg.get(name).config_cls)])
    assert dataclasses.asdict(treg.get(name).config_cls()) == \
        dataclasses.asdict(rreg.get(name).config_cls())
    for seed in (0, 3):
        ref_cfg = rreg.make_config(name, n_apps=60, seed=seed)
        got = treg.build_trace(_port_cfg(name, ref_cfg))
        _assert_same_trace(got, rreg.build_trace(ref_cfg))
        assert treg.scenario_of(got.cfg) == name


def test_registry_api_follows_the_reference():
    assert treg.scenario_names() == rreg.scenario_names()
    # the streamed wrapper: its fields, and its trace (the inner trace, the
    # seed overridden) column by column; its runs: tests/test_torch_stream.py
    assert ([f.name for f in dataclasses.fields(treg.get("stream").config_cls)]
            == [f.name for f in dataclasses.fields(rreg.get("stream").config_cls)])
    for seed in (None, 7):
        ref_cfg = rreg.get("stream").config_cls(
            inner=rreg.make_config("flashcrowd", n_apps=40, seed=2), window=8, seed=seed)
        ref_sim = dataclasses.replace(SimConfig(), workload=ref_cfg)
        port = convert.sim_config_from_dict(dataclasses.asdict(ref_sim), workload="stream",
                                            inner="flashcrowd").workload
        assert port == treg.make_config("stream", inner=port.inner, window=8, seed=seed)
        got = treg.build_trace(port)
        _assert_same_trace(got, rreg.build_trace(ref_cfg))
        assert treg.scenario_of(got.cfg) == "stream" and got.cfg == port
    with pytest.raises(ValueError, match="inner"):
        convert.sim_config_from_dict(dataclasses.asdict(ref_sim), workload="stream")
    # the fitted family is ported (its parity: tests/test_torch_sweep.py)
    assert treg.get("fitted").config_cls.__name__ == "FittedConfig"
    with pytest.raises(KeyError, match="unknown scenario"):
        treg.get("nope")
    # across families only the scale knobs carry; in one family the base stays
    base = treg.make_config("google", n_apps=77, seed=4)
    want = rreg.make_config("diurnal", rreg.make_config("google", n_apps=77, seed=4))
    got = treg.make_config("diurnal", base)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    same = treg.make_config("flashcrowd", tfam.FlashcrowdConfig(n_events=2), seed=9)
    assert (same.n_events, same.seed) == (2, 9)
    with pytest.raises(TypeError, match="not a registered"):
        treg.build_trace(object())


@pytest.mark.parametrize("fixture,preset", FIXTURES)
def test_replay_of_the_fixtures_equals_reference(fixture, preset):
    path = str(DATA / fixture)
    for kw in ({}, {"n_apps": 2}, {"max_components": 3}):
        _assert_same_trace(trep.load_trace(path, preset=preset, **kw),
                           rrep.load_trace(path, preset=preset, **kw))
    want = rreg.build_trace(rrep.ReplayConfig(path=path, preset=preset))
    got = treg.build_trace(trep.ReplayConfig(path=path, preset=preset))
    _assert_same_trace(got, want)
    assert got.n_apps == want.n_apps > 1
    with pytest.raises(ValueError, match="unknown replay preset"):
        trep.load_trace(path, preset="gcp")


def test_csv_round_trip_equals_reference(tmp_path):
    """A family's trace saved by both packages: the same bytes, and the
    same trace loaded back by both, equal to the one saved."""
    tr = treg.build_trace(tfam.HeavytailConfig(n_apps=12, seed=2))
    ref_tr = rreg.build_trace(rfam.HeavytailConfig(n_apps=12, seed=2))
    a, b = tmp_path / "port.csv", tmp_path / "ref.csv"
    trep.save_trace(tr, str(a))
    rrep.save_trace(ref_tr, str(b))
    assert a.read_bytes() == b.read_bytes()
    back = trep.load_trace(str(a))
    _assert_same_trace(back, rrep.load_trace(str(a)))
    # the file keeps the live components only: the table comes back as
    # wide as the widest app
    C = back.max_components
    assert C == int((tr.cpu_req > 0).sum(1).max()) and not tr.cpu_req[:, C:].any()
    for k in COLUMNS:
        want = getattr(tr, k)
        want = want[:, :C] if want.ndim > 1 else want
        np.testing.assert_array_equal(getattr(back, k), want, err_msg=k)


def _padded_one_app(mod) -> Trace:
    """One app in a table two components wide, one of them live."""
    n = 1
    lv = np.zeros((n, 2, mod.SEGMENTS, 2), np.float32)
    lv[:, 0] = 0.5
    return Trace(submit=np.zeros(n, np.float32), is_elastic=np.zeros(n, bool),
                 is_jumpy=np.zeros(n, bool), n_core=np.ones(n, np.int64),
                 n_elastic=np.zeros(n, np.int64), runtime=np.full(n, 60.0, np.float32),
                 cpu_req=np.array([[1.0, 0.0]], np.float32),
                 mem_req=np.array([[2.0, 0.0]], np.float32),
                 is_core=np.array([[True, False]]), levels=lv,
                 tenant=np.zeros(n, np.int64), slo=np.zeros(n, np.int64)).validate()


def test_the_reference_quirks_are_mirrored(tmp_path):
    """What the reference's code does where its property tests expect
    otherwise: numeric tenant ids are kept, not densely re-encoded, and a
    padded width is not kept by the round trip."""
    for names in (["7"], ["7", "t-a"], ["", "3"], ["t-b", "t-a", "t-b"]):
        np.testing.assert_array_equal(trep._tenant_codes(names), rrep._tenant_codes(names))
    assert trep._tenant_codes(["7"]).tolist() == [7]
    p = tmp_path / "one.csv"
    trep.save_trace(_padded_one_app(trep), str(p))
    got, want = trep.load_trace(str(p)), rrep.load_trace(str(p))
    _assert_same_trace(got, want)
    assert got.max_components == want.max_components == 1


def test_parquet_follows_the_reference(tmp_path):
    """With pandas and pyarrow both packages write and read Parquet;
    without them both raise RuntimeError."""
    tr = treg.build_trace(tfam.DiurnalConfig(n_apps=6))
    p = tmp_path / "t.parquet"
    if trep._pd is None:
        with pytest.raises(RuntimeError, match="pandas"):
            trep.save_trace(tr, str(p))
        return
    try:
        trep.save_trace(tr, str(p))
    except (ImportError, ValueError):
        pytest.skip("no parquet engine available")
    _assert_same_trace(trep.load_trace(str(p)), rrep.load_trace(str(p)))


@pytest.mark.parametrize("name", FAMILIES + ("replay",))
def test_sim_config_from_dict_takes_every_family(name):
    wl = (rrep.ReplayConfig(path=str(DATA / "azure_tiny.csv"), preset="azure")
          if name == "replay" else rreg.make_config(name, n_apps=30, seed=1))
    cfg = dataclasses.replace(SimConfig(), workload=wl)
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=name)
    assert type(pcfg.workload) is treg.get(name).config_cls
    assert dataclasses.asdict(pcfg.workload) == dataclasses.asdict(wl)
    _assert_same_trace(treg.build_trace(pcfg.workload), rreg.build_trace(wl))
    with pytest.raises(TypeError):
        convert.sim_config_from_dict(dataclasses.asdict(cfg),
                                     workload="google" if name != "google" else "diurnal")

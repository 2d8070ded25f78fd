"""The port's scenario matrix (``rmqtt_tpu_torch/bench/scenarios.py``): its
registry is the JAX package's profile for profile, and the tier-1 profile
``smoke_fast`` runs green through the port's in-process broker.

The module is a copy (``tests/test_torch_broker.py``'s copy check holds it
to the JAX module after the import rewrite); these cases hold what the copy
check cannot see, the profiles as objects and a live run. The one profile
that routes on the card's kernels, ``storm_churn_overload_kill``, runs in
``tests/test_torch_cuda.py`` and in ``chip_smoke.py`` phase 6h."""

import asyncio

import pytest

from rmqtt_tpu.bench import scenarios as J
from rmqtt_tpu_torch.bench import scenarios as T

_FIELDS = ("descr", "slo", "router", "env", "extra_toml", "subprocess_only",
           "slo_sample_interval", "slo_fast_window_s", "slo_slow_window_s")


def _steps(profile):
    return [[(name, fn.__name__, params) for name, fn, params in step]
            for step in profile.steps]


def test_registry_names_and_fast_subset():
    assert list(T.PROFILES) == list(J.PROFILES) and len(T.PROFILES) == 9
    assert T.FAST_SUBSET == J.FAST_SUBSET
    assert T.SCHEMA == "rmqtt_tpu_torch.scenario_report/1"


@pytest.mark.parametrize("name", sorted(J.PROFILES))
def test_profile_equals_the_jax_profile(name):
    jp, tp = J.PROFILES[name], T.PROFILES[name]
    assert _steps(tp) == _steps(jp)
    for f in _FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    assert getattr(tp.runner, "__name__", None) == getattr(jp.runner, "__name__", None)
    # the phase functions and runners are the port's own
    assert all(fn.__module__ == T.__name__ for step in tp.steps for _, fn, _ in step)
    assert tp.runner is None or tp.runner.__module__ == T.__name__
    args = (18831, 18832, "/scenario/workdir")
    assert T.profile_toml(tp, *args) == J.profile_toml(jp, *args)


def test_smoke_fast_in_process():
    """``smoke_fast`` (connect storm + subscribe churn, then an overload
    shed burst) through the port's broker, judged by its own SLO engine,
    asserted as ``tests/test_slo.py`` asserts the JAX package's run."""
    for name in T.FAST_SUBSET:
        assert name in T.PROFILES
    report = asyncio.run(asyncio.wait_for(
        T.run_profile_async("smoke_fast", inproc=True), timeout=120.0))
    assert report["ok"] is True, report
    assert report["schema"] == T.SCHEMA and report["mode"] == "inproc"
    assert {"profile", "phases", "goodput", "latency", "drops", "rss_mb",
            "slo", "slo_live", "duration_s"} <= set(report)
    names = [p["name"] for p in report["phases"]]
    assert names == ["connect_storm", "subscribe_churn", "overload_burst"]
    assert all(p["ok"] for p in report["phases"])
    assert report["drops"].get("shed_qos0", 0) > 0
    assert "publish.e2e" in report["latency"]
    assert report["latency"]["publish.e2e"]["p99_ms"] > 0
    assert report["slo_live"]["samples"] >= 1
    objs = {o["name"]: o for o in report["slo"]["objectives"]}
    assert set(objs) == {"publish-p99", "delivery"}
    assert all(o["compliant"] for o in objs.values())
    assert report["rss_mb"]["peak"] >= report["rss_mb"]["start"] > 0


def test_subprocess_only_profiles_refuse_in_process():
    with pytest.raises(ValueError, match="needs a subprocess broker"):
        T.ScenarioBroker(T.PROFILES["storm_churn_overload_kill"], "/nonexistent",
                         inproc=True)

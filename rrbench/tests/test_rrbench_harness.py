"""The harness finds each cell's files by name and refuses unknown ones;
the manifest and the files agree."""

import json

import pytest

from rrbench import harness


def test_every_cell_has_its_files():
    man = harness.manifest()
    for w in man["workloads"]:
        cell = harness.Cell(w["name"], 1, 1.0, False, "cpu", man=man)
        assert cell.driver().run
        assert set(cell.limits) and all(
            "limit" in v for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))


def test_every_configuration_and_metric_is_used():
    man = harness.manifest()
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_unknown_workload_is_refused():
    with pytest.raises(harness.UnknownName):
        harness.Cell("no-such-cell", 1, 1.0, False, "cpu")


def test_unknown_traffic_config_and_metric_are_refused(tmp_path):
    man = json.loads(json.dumps(harness.manifest()))
    man["workloads"][0]["traffic"] = "no_such_traffic"
    with pytest.raises(harness.UnknownName):
        harness.Cell(man["workloads"][0]["name"], 1, 1.0, False, "cpu",
                     man=man)
    man = harness.manifest()
    man["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(harness.UnknownName):
        harness.Cell(man["workloads"][0]["name"], 1, 1.0, False, "cpu",
                     man=man)
    with pytest.raises(harness.UnknownName):
        harness.reader("no_such_metric")


def test_unknown_traffic_kind_is_refused():
    cell = harness.Cell("rrnet-eval6", 1, 1.0, False, "cpu",
                        traffic={"kind": "no_such_kind"})
    with pytest.raises(harness.UnknownName):
        cell.driver()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    for name in ("rrnet_tpu_like", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_judge_fails_a_number_over_its_limit_or_not_finite():
    lim = {"a": {"limit": 0.5}, "b": {"limit": 0.5}}
    j = harness.judge({"a": 0.4, "b": 0.6}, lim)
    assert j["a"]["ok"] and not j["b"]["ok"]
    assert not harness.judge({"a": float("nan")}, lim)["a"]["ok"]
    assert not harness.judge({"c": 0.0}, lim)["c"]["ok"]

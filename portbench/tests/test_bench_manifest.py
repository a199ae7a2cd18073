"""Name discovery: every name in BENCHMARK.json finds its file, and a
manifest with a bad name or unit is refused."""

import copy

import pytest

from portbench.harness import cell, manifest


def test_the_manifest_holds():
    assert manifest.validate(cell.manifest()) == []


def test_each_cell_finds_its_files():
    bench = cell.manifest()
    for w in bench["workloads"]:
        c = cell.make_cell(bench, w["name"], 1, 1.0, False, 0.0)
        assert c.traffic["kind"] in ("serve_backlog", "finetune_fused")
        assert c.config["name"] == w["config"]
        assert set(c.limits)
        for m in cell.cell_metrics(bench, w["name"], True) + \
                cell.cell_metrics(bench, w["name"], False):
            assert callable(cell.metric_module(m["name"]).read)


@pytest.mark.parametrize("group,key,value", [
    ("per_layer", "name", "k1 roofline"),
    ("per_layer", "name", "serve/retrieve_ms"),
    ("end_to_end", "unit", "tokens per second"),
    ("end_to_end", "unit", "µs"),
    ("per_layer", "moves", "no_such_metric"),
    ("end_to_end", "source", "program_span"),
])
def test_a_bad_entry_is_refused(group, key, value):
    bench = copy.deepcopy(cell.manifest())
    bench[group][0][key] = value
    assert manifest.validate(bench)


def test_an_unknown_key_and_a_missing_reader_are_refused():
    bench = copy.deepcopy(cell.manifest())
    bench["per_layer"][0]["why"] = "no such key"
    assert manifest.validate(bench)
    bench = copy.deepcopy(cell.manifest())
    bench["per_layer"].append(dict(bench["per_layer"][0], name="no_reader"))
    assert any("no reader" in e for e in manifest.validate(bench))

"""BENCHMARK.json keeps the contract's shapes, every cell's pieces are found
by name, and a configuration, a traffic mix, a cell and a per-layer metric
are added as new files and entries alone."""
import hashlib
import json
import os
import re
import shutil

import pytest

from portbench import harness, port
from portbench.reference import psf

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(params=[False, True], ids=["benchmark", "with-held"])
def bench(request):
    return harness.manifest(held=request.param)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for section, keys in KEYS.items():
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
        for e in bench[section]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["per_layer"]:
        assert one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
        assert 0.01 <= m["bound"] <= 0.25
    assert entry_of(bench["end_to_end"], "setup_s")["bound"] == 0.25
    assert all(one_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert len(json.dumps(bench)) <= 64 * 1024


def entry_of(items, name):
    return harness.entry(items, name)


def test_run_seconds_fit_a_check_of_24_cells(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_each_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        layers = harness.per_layer(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["workloads"], m["name"]
        for name in m["workloads"]:
            entry_of(bench["workloads"], name)


def test_every_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        c = harness.cell(bench, w["name"], 1, "cpu")
        assert c.config["name"] == w["config"]
        harness.driver(c)
    for m in bench["per_layer"]:
        assert callable(harness.reader(m).read)
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")


def digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_files_are_found_without_editing_any(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "gaussian-wheel-512.json")) as f:
        config = json.load(f)
    config["name"] = "gaussian-wheel-512-dft"
    config["sapg_options"]["fft_mode"] = "dft"
    with open(os.path.join(pb, "configs", "gaussian-wheel-512-dft.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", "sapg-b4.json"), "w") as f:
        json.dump({"driver": "sapg_runs", "metric": "chain_iter_per_s", "n_chains": 4,
                   "trace_from": 10, "trace_steps": 8}, f)
    with open(os.path.join(pb, "cells", "gaussiandft512-b4.json"), "w") as f:
        json.dump({"limits": {"theta": 1e-3, "sigma2": 1e-3, "x_last": 1e-3}}, f)
    with open(os.path.join(pb, "metrics", "estimator.idle_ms_per_iter.py"), "w") as f:
        f.write('UNIT = "ms/iter"\nLAYER = "sapg/estimator"\nMOVES = "chain_iter_per_s"\n\n\n'
                'def read(r):\n    return None\n')
    bench = harness.manifest(root)
    bench["configs"].append({"name": config["name"], "source": "https://example.org/demo",
                             "file": "portbench/configs/gaussian-wheel-512-dft.json",
                             "reduced": ["samples", "warmup"], "why": "the dense-DFT transforms"})
    bench["workloads"].append({"name": "gaussiandft512-b4", "config": config["name"],
                               "traffic": "sapg-b4", "chips": 1, "why": "four chains, dft"})
    bench["end_to_end"][1]["workloads"].append("gaussiandft512-b4")
    bench["per_layer"].append({"name": "estimator.idle_ms_per_iter", "unit": "ms/iter",
                               "better": "lower", "source": "device_trace",
                               "layer": "sapg/estimator", "moves": "chain_iter_per_s",
                               "workloads": ["gaussiandft512-b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    c = harness.cell(bench, "gaussiandft512-b4", 5, "cpu", root)
    assert c.config["name"] == "gaussian-wheel-512-dft" and c.traffic["n_chains"] == 4
    assert port.demo_config(c.config).sapg.fft_mode == "dft"
    assert harness.driver(c, root).B == 4
    names = [m["name"] for m in harness.per_layer(bench, "gaussiandft512-b4")]
    assert names == ["estimator.idle_ms_per_iter"]
    assert harness.reader(harness.entry(bench["per_layer"], names[0]), root).read({}) is None
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}


def test_a_psf_family_is_found_by_name(tmp_path, monkeypatch):
    import torch

    shutil.copytree(psf.FAMILY_DIR, tmp_path / "psfs", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "psfs" / "box.py").write_text(
        'import torch\n\nPARAMS = ("w",)\n\n\n'
        'def kernel(size, params, demo, dtype, device):\n'
        '    f = params["w"] * torch.ones((size, size), dtype=dtype, device=device)\n'
        '    return f, [f / params["w"]]\n')
    monkeypatch.setattr(psf, "FAMILY_DIR", str(tmp_path / "psfs"))
    w = torch.tensor(2.0, dtype=torch.float64)
    k, dks = psf.kernel_and_grads({"psf": "box", "psf_size": 3}, {"w": w}, torch.float64, "cpu")
    assert torch.allclose(k, torch.full((3, 3), 1 / 9, dtype=torch.float64))
    assert set(dks) == {"w"} and float(dks["w"].abs().max()) < 1e-15
    with pytest.raises(FileNotFoundError):
        psf.family("no-such-family")

"""``BENCHMARK.json`` against the benchmark's rules that a file can be
checked for, and every name it gives found as a file of the harness."""

import re

from portbench import spec
from pb_helpers import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/") and (spec.ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_name_is_a_file():
    b = bench()
    for w in b["workloads"]:
        cell = spec.find_cell(w["name"], b)
        assert (spec.HERE / "drivers" / f"{cell.cell['driver']}.py").is_file()
        assert (spec.HERE / "traffic" / f"{cell.traffic['kind']}.py").is_file()
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(spec.metric_reader(m["name"]), "read")
        for m in cell.per_layer:
            assert m["moves"] in e2e
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_every_config_names_its_architecture():
    for c in bench()["configs"]:
        config = spec.load_json(spec.ROOT / c["file"])
        assert (spec.HERE / "reference" / f"{config['reference']}.py").is_file()
        mod = spec.reference(config)
        assert all(callable(getattr(mod, n)) for n in spec.INTERFACE)

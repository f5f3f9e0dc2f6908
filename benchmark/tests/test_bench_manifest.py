"""BENCHMARK.json against the contract's form and against its own files."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "freeze_omni_tpu"}


def metrics():
    return DOC["end_to_end"] + DOC["per_layer"]


def cells_of(metric):
    return metric.get("workloads", [c["name"] for c in DOC["workloads"]])


def test_keys_and_sizes():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(DOC["workloads"]) <= 24 and 1 <= len(DOC["configs"]) <= 24


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric_form(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in DOC["end_to_end"]:
        assert set(m) <= allowed | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= allowed | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert (BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("m", DOC["per_layer"], ids=lambda m: m["name"])
def test_metric_cells_report_what_it_moves(m):
    e2e = {x["name"]: x for x in DOC["end_to_end"]}
    assert m["moves"] in e2e
    for cell in cells_of(m):
        assert cell in cells_of(e2e[m["moves"]])


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    names = {c["name"] for c in DOC["configs"]}
    assert NAME.match(cell["name"]) and cell["config"] in names
    assert NAME.match(cell["traffic"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    e2e = [m["name"] for m in DOC["end_to_end"] if cell["name"] in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in cells_of(m) for m in DOC["per_layer"])


@pytest.mark.parametrize("conf", DOC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.exists() and conf["file"].startswith("benchmark/")
    doc = json.loads(path.read_text())
    assert doc["name"] == conf["name"] and conf["reduced"] == []
    llm = doc["dims"]["llm"]
    # the published Qwen2-7B-Instruct sizes, whole
    assert (doc["hidden_size"], doc["num_hidden_layers"], doc["num_attention_heads"],
            doc["num_key_value_heads"], doc["intermediate_size"],
            doc["vocab_size"]) == (llm["hidden"], llm["num_layers"], llm["num_heads"],
                                   llm["num_kv_heads"], llm["ffn"], llm["vocab_size"])
    assert (llm["hidden"], llm["num_layers"], llm["ffn"]) == (3584, 28, 18944)
    assert any(c["config"] == conf["name"] for c in DOC["workloads"])
    lim = doc["limits"]
    for k in ("vad_status_mismatch", "submit_mismatch", "missing"):
        assert lim[k] == 0


def test_unique_names():
    for group in (DOC["configs"], DOC["workloads"], metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    """Whole top-level names: freeze_omni_tpu_torch is not freeze_omni_tpu."""
    found = set(_imports(path))
    assert not found & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "freeze_omni_tpu_torch" not in found

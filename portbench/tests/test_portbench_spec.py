"""BENCHMARK.json resolves by name to its files, keeps to the
contract's shapes, and the harness refuses what it cannot run."""

import json
import os
import re
import shutil
import subprocess
import sys


from portbench import guard, harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the references that compute the P25 judge's numbers
P25_REFERENCES = ("p25_pipelined", "wideband_batched")


def test_every_name_resolves_to_its_files():
    for cell in SPEC["workloads"]:
        w = harness.resolve(SPEC, cell["name"])
        assert hasattr(w.entry, "Entry") and hasattr(w.reference,
                                                     "Reference")
        assert callable(w.inputs.make_ring)
        assert os.path.isfile(os.path.join(
            harness.PKG, "traffic", f"{cell['traffic']}.json"))
        assert w.end_to_end and w.per_layer
        assert {m["name"] for m in w.end_to_end} >= {"setup_s"}
        # the CPU tests' size of the cell
        assert isinstance(w.cfg["small"], dict)
        assert isinstance(w.mix["small"], dict)
    for c in SPEC["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["limits"] and all(v >= 0 for v in cfg["limits"].values())
        if cfg["reference"] in P25_REFERENCES:
            assert set(cfg["limits"]) >= {"frames_diff", "pcm_rms_rel",
                                          "carry_rel"}
    for m in SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for m in SPEC["end_to_end"]:
        assert callable(harness.reader(m["name"], "end_to_end"))


def test_the_harness_names_no_configuration_kernel_or_stage():
    """What belongs to one configuration lives in the files it names, so
    a configuration can be added as new files: the shared modules name
    no configuration, entry, kernel or stage of the port."""
    words = re.compile(r"p25|c4fm|wideband|band_|fir_disc|adpcm|imbe|"
                       r"frontend|pick|pcm|ldu|channeliz", re.I)
    for f in ("harness.py", "run.py", "trace.py", "stats.py", "compare.py",
              "guard.py", "roofline.py", "control.py", "hostinfo.py",
              "spans.py"):
        with open(os.path.join(harness.PKG, f)) as fh:
            code = "\n".join(ln for ln in fh.read().splitlines()
                             if not ln.lstrip().startswith("#"))
        assert not words.search(code.split('"""', 2)[-1]), (
            f, words.findall(code.split('"""', 2)[-1]))


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) < 64 * 1024


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["dsdneo_tpu_torch", "dsdneo_tpu_torch.ops",
                            "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["dsdneo_tpu", "dsdneo_tpu.ops", "jax.numpy",
                            "jaxlib", "flax.linen"]) == sorted(
        ["dsdneo_tpu", "dsdneo_tpu.ops", "jax.numpy", "jaxlib",
         "flax.linen"])


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         SPEC["workloads"][0]["name"],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_a_run_without_a_card_fails():
    """Without a card the run exits with another code than 0 and prints
    no result; it never falls back to the CPU."""
    p = _run(harness.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "no CUDA device" in p.stderr


def test_the_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's own
    files (no port beside it) the run fails and prints no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_no_module_of_the_benchmark_imports_jax():
    """The harness's sources import neither JAX nor the JAX package;
    each file names the port only as ``dsdneo_tpu_torch``."""
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|dsdneo_tpu)\b"
                     r"(?!_torch)", re.M)
    for d, _s, files in os.walk(harness.PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not bad.search(fh.read()), f


def test_the_reference_imports_nothing_of_the_port():
    for f in os.listdir(os.path.join(harness.PKG, "reference")):
        if f.endswith(".py"):
            with open(os.path.join(harness.PKG, "reference", f)) as fh:
                assert "dsdneo_tpu" not in fh.read().replace(
                    "``dsdneo_tpu_torch``", ""), f

"""The harness end to end on the CPU at a size a test holds: the result
line's contract, the refusal without a card, the look for JAX, and cells,
mixes, metrics and byte counts found by name."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contracts_keys(tiny_cell, name, trace):
    cell = tiny_cell(name)
    out = harness.run_cell(ROOT, name, 2**31 + 17, 1.0, bool(trace),
                           device="cpu", cell=cell)
    json.dumps(out)
    assert out["correct"] is True, out["notes"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert {"device_ops", "idle_gaps"} == set(out["breakdown"])
        assert all(len(v) <= 10 for v in out["breakdown"].values())
        names = {m["name"] for m in cell.per_layer}
        assert set(out["metrics"]) <= names
        assert "serve.plan_hit_rate" in out["metrics"]
        if name == "lubm1.replay":
            assert {"serve.qps", "serve.p50_ms"} <= set(out["metrics"])
    else:
        e2e = {"lubm1.replay": {"p95_ms", "setup_s"},
               "lubm1.fresh": {"qps", "p50_ms", "p95_ms", "setup_s"}}
        assert set(out["metrics"]) == e2e[name]
        assert all(m["value"] > 0 for m in out["metrics"].values())
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        "--workload", "lubm1.replay", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_with_only_the_benchmarks_files_the_run_fails(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "lubm1.replay", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


def test_jax_and_the_jax_package_are_found_by_whole_name():
    assert harness.forbidden_modules(["numpy", "repro_torch",
                                      "repro_torch.serve", "bench.run",
                                      "jaxtyping", "reprox"]) == []
    assert harness.forbidden_modules(["repro_torch", "jax.numpy", "repro",
                                      "repro.core", "jaxlib", "flax.nn"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_cell, tmp_path):
    """A whole run on the CPU in a process of its own: the port, the
    harness and the reference load no module named jax or repro."""
    code = ("import sys, json; from pathlib import Path; "
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            "from bench import harness; "
            "cell = harness.load_cell(Path(sys.path[0]), 'lubm1.fresh'); "
            "import bench.gen.uba as uba; uba.DEPARTMENTS = (1, 1); "
            "cell.mix.update(warmup=2, deck=32, per_second=100, sample=4); "
            "out = harness.run_cell(Path(sys.path[0]), 'lubm1.fresh', 9, "
            "0.5, True, device='cpu', cell=cell); "
            "print(json.dumps([out['correct'], harness.forbidden_modules(), "
            "'repro_torch' in sys.modules]))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_a_cell_mix_metric_and_byte_count_added_as_files_are_found(tmp_path):
    """A later change adds a data generator, a configuration, a mix (here
    with templates of 4 nodes), a per-layer metric and a kernel's byte
    count as new files and new BENCHMARK.json entries, and edits
    nothing."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "bench"
    (b / "gen" / "ring.py").write_text(
        "import numpy as np\n"
        "from . import Triples\n\n\n"
        "def generate(config):\n"
        "    n = config['nodes']\n"
        "    rng = np.random.default_rng(config['data_seed'])\n"
        "    s = [f'N/{i:04d}' for i in range(n)] * 2\n"
        "    o = [f'N/{(i + 1) % n:04d}' for i in range(n)]\n"
        "    o += [f'tag{k}' for k in rng.integers(0, 9, n)]\n"
        "    p = ['next'] * n + ['tag'] * n\n"
        "    return Triples(np.asarray(s), np.asarray(p), np.asarray(o),\n"
        "                   set(o[n:]))\n")
    cfg = json.loads((b / "configs" / "lubm1.json").read_text())
    cfg.update(generator="ring", nodes=300)
    (b / "configs" / "ring.json").write_text(json.dumps(cfg))
    (b / "mixes" / "trio.json").write_text(json.dumps(
        {"kind": "replay", "clients": 3, "template_size": 4, "pool": 6,
         "pool_seed": 1, "zipf": 1.3, "deck": 30, "per_second": 3000,
         "sample": 6}))
    (b / "metrics" / "serve.queries_seen.py").write_text(
        "def read(ctx):\n    return ctx.tel['batch']['queries']\n")
    (b / "metrics" / "searchsorted_roofline.py").write_text(
        "def read(ctx):\n    return ctx.probe.roofline('sorted_probe')\n")
    (b / "roofline" / "sorted_probe.py").write_text(
        "MODULE = 'repro_torch.kernels.ref'\nATTR = 'merge_probe_sorted'\n"
        "KERNELS = ('searchsorted',)\n\n\n"
        "def cost(a, b, *args, **kwargs):\n"
        "    return 4 * (3 * len(a) + len(b)), 0\n")
    spec["configs"].append({"name": "ring", "source": "test",
                            "file": "bench/configs/ring.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "ring.trio", "config": "ring",
                              "traffic": "trio", "chips": 1, "why": "test"})
    for name in ("serve.queries_seen", "searchsorted_roofline"):
        spec["per_layer"].append({"name": name, "unit": "n",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "serve", "moves": "qps",
                                  "workloads": ["ring.trio"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; from pathlib import Path; "
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]; "
            "from bench import harness; "
            f"out = harness.run_cell(Path({str(tmp_path)!r}), "
            "'ring.trio', 3, 3.0, True, device='cpu'); "
            "print(json.dumps(out))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["notes"]
    assert out["attempted"] > 0
    m = out["metrics"]
    assert m["serve.queries_seen"]["value"] == out["attempted"]
    assert m["searchsorted_roofline"]["value"] > 0
    assert "check.ms" not in m

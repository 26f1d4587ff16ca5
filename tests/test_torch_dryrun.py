"""The port's dry-run tools (launch.op_analysis, launch.dryrun,
launch.roofline) on the CPU.

* op_analysis, a twin of tests/test_hlo_analysis.py: the same
  four-iteration program (tanh(x @ a) @ b over stacked weights, then
  logsumexp) on a (2, 4) mesh of a fake world of 8 ranks, meta tensors,
  with the layout XLA picks for the reference made explicit (each
  iteration's partial product reduced: Sharder.c): the per-device FLOPs
  equal the hand count exactly, and the all-reduces of the partial
  products number at least 4 with at least 4·4·64·4 bytes.
* roofline.terms on a fixed record against a hand computation with the
  H100 constants.
* dryrun's records carry the reference's keys (its run_cell and
  run_rdfh_cell), through the CLI for the RDF-h check cell.
* the counted FLOPs of one reduced train cell (qwen2, 8 x 32 tokens,
  microbatch 2, on a (4, 2) mesh) against the reference's
  hlo_analysis.analyze of the same cell (8 forced host devices, Auto
  axes).  The reference's count per device is exactly the port's count
  of the whole step on a (1, 1) mesh over 8: XLA splits the work with no
  redundancy.  The port's per-device count measured 1.14 times the
  reference's while the partial cotangents over 'model' (of the loss
  head's and the sublayers' inputs) were left to DTensor, which gathered
  a small weight and ran its product at full width on every 'model'
  rank; the port now reduces them where the reference does, and the
  count is equal.  The bound is 1.0 to 1.2.
* the same cell's collectives, kind by kind, against the reference's,
  with bounds derived from the port's split of them by issuer.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch import op_analysis, roofline

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    return env


def _run(code: str, **env):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=600,
                         env=_env(**env))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_op_counter_counts_loops_and_collectives():
    """In a subprocess: the fake default group is global to a process."""
    r = _run("""
    import json, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models.nn_ops import Sharder
    from repro_torch.models.param import PS
    from repro_torch.runtime import reshard
    N_ITERS, B, D, F = 4, 8, 64, 128

    def f(w1, w2, x):
        for i in range(N_ITERS):
            # GSPMD's layout for the reference: each iteration's partial
            # product reduced (DTensor would carry the partial sum into
            # the next product, gathering its weights)
            x = shd.c(torch.tanh(x @ w1[i]) @ w2[i], "data", None)
        return torch.logsumexp(x.reshape(-1), 0)

    with fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        shd = Sharder(mesh=mesh, dp="data", tp_heads=False, tp_kv=False)
        meta = {"w1": torch.empty(N_ITERS, D, F, device="meta"),
                "w2": torch.empty(N_ITERS, F, D, device="meta"),
                "x": torch.empty(B, D, device="meta")}
        args = reshard(meta, mesh, {"w1": PS(None, None, "model"),
                                    "w2": PS(None, "model", None),
                                    "x": PS("data", None)})
        _, a = analyze(f, args["w1"], args["w2"], args["x"])
    # per device: [B/2, D] @ [D, F/4] and the partial [B/2, F/4] @
    # [F/4, D], each iteration
    want = N_ITERS * (2 * (B // 2) * (F // 4) * D
                      + 2 * (B // 2) * D * (F // 4))
    print(json.dumps({"flops": a["flops"], "want": want,
                      "ar_count": a["collectives"]["all-reduce"]["count"],
                      "ar_bytes": a["collectives"]["all-reduce"]["bytes"],
                      "keys": sorted(a)}))
    """)
    assert r["flops"] == r["want"], r
    # the second product's contraction is sharded -> one all-reduce of
    # [B/2, D] f32 per iteration
    assert r["ar_count"] >= 4, r
    assert r["ar_bytes"] >= 4 * (8 // 2) * 64 * 4, r
    assert {"flops", "hbm_bytes", "hbm_bytes_min", "collective_bytes",
            "collectives"} <= set(r["keys"])


def test_op_counter_peak_follows_storages():
    """A storage counts from the op that allocates it until its last
    tensor (a view included) dies."""
    with op_analysis.OpCounter() as c:
        a = torch.empty(1024, device="meta") + 1     # 4 KiB + 4 KiB temp
        v = a[:10]
        del a                                        # v holds a's storage
        b = torch.empty(256, device="meta") * 2      # 1 KiB + 1 KiB temp
        del v, b
        d = torch.empty(512, device="meta").exp()    # 2 KiB + 2 KiB temp
        assert c.live_bytes == 2048
    assert c.peak_bytes == 8192
    del d


def test_roofline_terms_by_hand():
    rec = {"status": "ok", "mesh": "single", "model_flops": 256 * 989e12,
           "memory": {"peak_estimate_bytes": 3 * 2**30},
           "analysis": {"flops": 2 * 989e12, "hbm_bytes": 6.7e12,
                        "hbm_bytes_min": 3.35e12,
                        "collective_bytes": 25e9}}
    t = roofline.terms(rec)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["mem_min_s"] == pytest.approx(1.0)
    assert t["mem_max_s"] == pytest.approx(2.0)
    assert t["coll_s"] == pytest.approx(0.5)
    assert t["dominant"] == "compute"
    assert t["useful_ratio"] == pytest.approx(0.5)
    assert t["roofline_frac"] == pytest.approx(0.5)
    assert t["peak_gib"] == pytest.approx(3.0)
    assert roofline.terms({"status": "error"}) is None
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 50e9)


REF_RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "settings",
                   "lower_s", "compile_s", "memory", "cost", "collectives",
                   "analysis", "hlo_bytes", "model_flops", "status"}
REF_RDFH_KEYS = {"arch", "shape", "mesh", "settings", "lower_s",
                 "compile_s", "memory", "cost", "analysis", "model_flops",
                 "status"}


def test_dryrun_cli_writes_the_reference_keys(tmp_path):
    out = tmp_path / "dry.json"
    r = _run(f"""
    import json
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "rdfh-check-phase", "--shape", "n4M_cap256",
                 "--out", {str(out)!r}])
    print(json.dumps(json.load(open({str(out)!r}))))
    """)
    rec = r["rdfh-check-phase|n4M_cap256|single"]
    assert rec["status"] == "ok", rec
    assert REF_RDFH_KEYS <= set(rec)
    assert rec["mesh_shape"] == [16, 16]
    # 4,194,304 rows of 256 ids over 16 data shards: each device's ids
    a = rec["analysis"]
    assert rec["memory"]["argument_size_in_bytes"] == \
        (1 << 22) // 16 * 256 * 4 + 3 * 8 * 4
    # the global count is one all-reduce of an int64 scalar
    assert a["collectives"]["all-reduce"] == {"count": 1.0, "bytes": 8.0}
    assert set(rec["memory"]) >= {"argument_size_in_bytes",
                                  "temp_size_in_bytes",
                                  "peak_estimate_bytes"}


def test_dryrun_all_traces_each_cell_in_a_process(tmp_path):
    """--all traces every cell in a process of its own and records a
    cell whose process fails as an error with its reason; the RDF-h cell
    is always one of them (the architecture cells stand in for two here:
    one ok, one unknown)."""
    out = tmp_path / "dry.json"
    r = _run(f"""
    import json
    from repro_torch.launch import dryrun
    dryrun.all_cells = lambda kinds: iter(
        [("nosuch", "train_4k", k) for k in kinds])
    dryrun.main(["--all", "--out", {str(out)!r}])
    print(json.dumps(json.load(open({str(out)!r}))))
    """)
    assert set(r) == {"rdfh-check-phase|n4M_cap256|single",
                      "nosuch|train_4k|single"}
    assert r["rdfh-check-phase|n4M_cap256|single"]["status"] == "ok"
    bad = r["nosuch|train_4k|single"]
    assert bad["status"] == "error" and "unknown arch" in bad["error"]


def test_dryrun_cells_and_settings_match_reference():
    """In a subprocess: importing the reference's dryrun sets XLA_FLAGS
    for 512 host devices."""
    r = _run("""
    import json
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import dryrun as jdry
    from repro_torch.launch import dryrun
    print(json.dumps({
        "cells": list(dryrun.all_cells()) == list(jdry.all_cells()),
        "n": len(list(dryrun.all_cells())),
        "settings": dryrun.TRAIN_SETTINGS == jdry.TRAIN_SETTINGS and all(
            dryrun.cell_settings(a) == jdry.cell_settings(a)
            for a in dryrun.ARCHS),
        "model_flops": all(
            dryrun.model_flops(a, s) == jdry.model_flops(a, JSHAPES[n])
            for a in dryrun.ARCHS for n, s in dryrun.SHAPES.items())}))
    """)
    assert r == {"cells": True, "n": 62, "settings": True,
                 "model_flops": True}


CELL = ("qwen2-0.5b", 32, 8, 2)      # arch, seq, batch, microbatch


def test_reduced_cell_flops_against_reference():
    name, seq, b, mb = CELL
    ref = _run(f"""
    import json, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS, AxisType
    from repro.configs import ARCHS, reduced_config
    from repro.configs.base import InputShape, TrainConfig
    from repro.launch.hlo_analysis import analyze
    from repro.models import api
    cfg = reduced_config(ARCHS[{name!r}])
    tcfg = TrainConfig(microbatch={mb})
    shape = InputShape("t", {seq}, {b}, "train")
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, PS))
    args = (api.abstract_model(cfg), api.opt_abstract(cfg, tcfg),
            api.batch_abstract(cfg, shape),
            jax.ShapeDtypeStruct((), jnp.int32))
    with mesh:
        txt = jax.jit(api.make_train_step(cfg, tcfg, mesh), in_shardings=(
            ns(api.model_pspecs(cfg, mesh)), ns(api.opt_pspecs(cfg, mesh)),
            ns(api.batch_pspecs(cfg, shape, mesh)),
            NamedSharding(mesh, PS()))).lower(*args).compile().as_text()
    print(json.dumps({{"flops": analyze(txt)["flops"]}}))
    """, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    got = _run(f"""
    import json, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    cfg = reduced_config(ARCHS[{name!r}])
    shape = InputShape("t", {seq}, {b}, "train")
    st = dict(dryrun.cell_settings({name!r}), microbatch={mb})
    with dryrun.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                          mesh_dim_names=("data", "model"))
        fn, args = dryrun.lower_cell({name!r}, None, mesh, cfg=cfg,
                                     shape=shape, settings=st)
        sec, memory, a = dryrun.trace(fn, args, True)
        rec = dryrun.record({{"arch": {name!r}, "mesh": "single",
                             "mesh_shape": [4, 2], "shape": "t",
                             "settings": st, "model_flops": 0.0}},
                            sec, memory, a)
    print(json.dumps({{"flops": a["flops"], "keys": sorted(rec)}}))
    """)
    ratio = got["flops"] / ref["flops"]
    assert 1.0 <= ratio <= 1.2, (got, ref, ratio)
    assert REF_RECORD_KEYS <= set(got["keys"])


def test_reduced_cell_collectives_against_reference():
    """The same reduced cell's collectives, kind by kind, against the
    reference's hlo_analysis.analyze (8 forced host devices, Auto axes),
    both from scripts/dryrun_reference_cell.py --reduced.

    The bounds come from the port's split (`collectives_by_op`) and the
    two places where the reference's layout reduces more:
      * every gradient is reduced over 'data' once a microbatch, in both;
        the port's split shows it as the gradients put in their
        parameters' placements (`redistribute:fw @ api.py:grad_fn`),
        exactly the parameters' local bytes times the microbatches;
      * the reference reduces the tied embedding's loss-head gradient
        inside the loss-chunk loop, once a chunk (n_mb·n_chunks·V/2·D·4
        bytes), where the port reduces the whole embedding gradient once
        a microbatch (counted above);
      * the reference's remat recompute repeats each FFN output's
        reduction over 'model' (n_mb·L·(B/n_mb/4)·S·D·4 bytes), which the
        port's checkpoint does not recompute: it stops at the last saved
        tensor, before the w2 product;
    so the port's all-reduce bytes are the reference's less those two,
    within 1 % of the reference's (scalars: the loss mean and the norm).
    The port's only all-gathers regroup the token ids into microbatches;
    the reference gathers the gold logit out of the vocab-sharded logits
    (take_along_axis: all-gathers and collective-permutes, and their
    scatter-add transpose), which the port takes on each shard as a
    partial sum reduced with the logsumexp: at most the reference's
    all-gather bytes, and no permute.  Reduce-scatter and all-to-all: none
    on either side.  Counts: XLA's combiner merges each microbatch's
    gradient reductions into one tuple all-reduce, the port issues one a
    tensor: at least the reference's count."""
    name, seq, b, mb = CELL
    # scripts/dryrun_reference_cell.py lowers both cells (qwen2-0.5b) on
    # (4, 2) Auto axes and prints them as its last line
    script = Path(SRC).parent / "scripts" / "dryrun_reference_cell.py"
    out = subprocess.run(
        [sys.executable, str(script), "--mesh", "4,2",
         "--reduced", f"{seq},{b},{mb}"], capture_output=True, text=True,
        timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    cell = json.loads(out.stdout.strip().splitlines()[-1])
    assert cell["arch"] == name
    ref, got = cell["reference"]["collectives"], cell["port"]
    coll, split = got["collectives"], got["collectives_by_op"]
    cfg = got["cfg"]
    L, d, vocab, chunk = (cfg["num_layers"], cfg["d_model"],
                          cfg["vocab_size"], cfg["loss_chunk"])
    assert cfg["tie_embeddings"]
    for kind, parts in split.items():        # the split sums to the kinds
        assert sum(p["count"] for p in parts.values()) == \
            coll[kind]["count"], kind
        assert sum(p["bytes"] for p in parts.values()) == \
            coll[kind]["bytes"], kind
    grads = split["all-reduce"]["redistribute:fw @ api.py:grad_fn"]
    assert grads["bytes"] == mb * got["param_bytes"], (grads, got)
    embed_per_chunk = mb * (seq // chunk) * (vocab // 2) * d * 4
    ffn_recompute = mb * L * (b // mb // 4) * seq * d * 4
    want = ref["all-reduce"]["bytes"] - embed_per_chunk - ffn_recompute
    assert abs(coll["all-reduce"]["bytes"] - want) <= \
        0.01 * ref["all-reduce"]["bytes"], (coll, ref, want)
    assert coll["all-reduce"]["count"] >= ref["all-reduce"]["count"]
    assert set(split["all-gather"]) == {"redistribute:fw @ nn_ops.py:c"}
    assert 0 < coll["all-gather"]["bytes"] <= ref["all-gather"]["bytes"]
    assert coll["collective-permute"] == {"count": 0.0, "bytes": 0.0}
    for kind in ("reduce-scatter", "all-to-all"):
        assert coll[kind] == ref[kind] == {"count": 0.0, "bytes": 0.0}


def test_roofline_tables_list_every_cell(tmp_path, capsys):
    """--md and --mesh both: one row per cell, a failed cell with its
    reason."""
    ok = {"status": "ok", "model_flops": 256 * 989e12,
          "memory": {"peak_estimate_bytes": 2**30},
          "analysis": {"flops": 989e12, "hbm_bytes": 3.35e12,
                       "hbm_bytes_min": 3.35e12, "collective_bytes": 0.0}}
    results = {
        "a|train_4k|single": {**ok, "arch": "a", "shape": "train_4k",
                              "mesh": "single"},
        "a|train_4k|multi": {**ok, "arch": "a", "shape": "train_4k",
                             "mesh": "multi", "model_flops": 512 * 989e12},
        "b|decode_32k|single": {"arch": "b", "shape": "decode_32k",
                                "mesh": "single", "status": "error",
                                "error": "RuntimeError: no strategy\nmore"}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(results))
    roofline.main(["--json", str(path), "--md"])
    out = capsys.readouterr().out.splitlines()
    assert out[2] == ("| a | train_4k | 1.000 | [1.000, 1.000] | 0.000 |"
                      " compute | 1.00 | 1.00 | 1.0 |")
    assert out[3].startswith("| b | decode_32k | FAILED: RuntimeError: "
                             "no strategy |")
    roofline.main(["--json", str(path), "--mesh", "both"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].count("|") == 17
    assert out[2].count("compute") == 2
    assert "FAILED: no record" in out[3]

"""Twins of tests/test_system.py: the port's end-to-end runs against the
reference, one twin per reference case.

* The RDF runs (the dblp pipeline, the result columns) go through
  `torch_twin.twin` (`impl="ref"`, the port on the CPU): the reference
  test's claims on each side, and the result sets and count-valued
  statistics of every execution equal across the sides.
* The LM runs carry the reference's weights into the port
  (`convert.params_from_reference`) and feed both the same numpy
  batches, float32 at `reduced_config`, with the tolerances that the
  port's other LM twins state for the same quantities:
    - a train step's loss: 1e-5 relative (tests/test_torch_lm_train.py);
    - prefill and decode logits: max|Δ| <= 1e-4·max(1, max|ref|)
      (tests/test_torch_lm_models.py; tests/test_torch_lm_decode.py's
      2e-2 is for bf16 and for decode against prefill);
    - `pos` and the greedy tokens: equal.
  The port's own checkpoint replay is also held to the reference test's
  bound, 1e-4 absolute.
"""
import jax
import numpy as np
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import InputShape as JShape, TrainConfig as JTrain
from repro.data.lm_data import TokenPipeline as JPipeline
from repro.models import api as japi
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.lm_data import TokenPipeline
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.optim import adamw_init

from torch_twin import run_stats, twin

LOSS_REL = 1e-5          # a train step's loss (test_torch_lm_train.py)
LOGIT_REL = 1e-4         # logits (test_torch_lm_models.py)
REPLAY = 1e-4            # the reference test's replay bound


def test_rdf_pipeline_end_to_end():
    """Twin of test_system.py::test_rdf_pipeline_end_to_end."""
    def scenario(S):
        g = S.data.DATASETS["dblp"](scale=0.04, seed=3)
        eng = S.engine(g)
        n_match, used, runs = 0, 0, []
        for s in range(6):
            r = eng.execute(S.query(g, size=5, seed=40 + s))
            n_match += r.count
            used += r.stats.used_check
            runs.append((r.result_set(), run_stats(r)))
        assert n_match > 0
        return n_match, used, runs
    twin(scenario)


def test_engine_result_columns_cover_query():
    """Twin of test_system.py::test_engine_result_columns_cover_query:
    every row of the first 50 inside its node's interval, on each side."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        q = S.query(g, size=5, seed=9)
        eng = S.engine(g, "h2")
        r = eng.execute(q)
        assert sorted(r.cols) == list(range(q.num_nodes))
        iv = q.intervals(S.engine(g, "h2").idmap)
        for row in r.rows[:50]:
            for col, node in zip(r.cols, row):
                lo, hi = iv[col]
                assert lo <= node < hi
        return (tuple(r.cols), r.result_set(), run_stats(r),
                tuple(tuple(int(x) for x in v) for v in iv))
    twin(scenario)


def _close(got, want, rel):
    assert abs(got - want) <= rel * max(abs(want), 1.0), (got, want)


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= LOGIT_REL * max(float(np.abs(want).max()), 1.0), err


def test_train_checkpoint_restart_continuity(tmp_path):
    """Twin of test_system.py::test_train_checkpoint_restart_continuity:
    four steps of qwen2 at reduced_config, a checkpoint before step 2,
    and steps 2-3 replayed from it, in both packages on the reference's
    weights and batches.  Each step's loss, first run and replay, within
    LOSS_REL of the reference's; each package's replay within REPLAY of
    its own first run."""
    name = "qwen2-0.5b"
    tc = dict(lr=1e-3, microbatch=1, total_steps=20, warmup=1)

    # the reference, as its test runs it
    cfg = jreduced(JARCHS[name])
    pipe = JPipeline(cfg.vocab_size, 32, 4, seed=1)
    step = jax.jit(japi.make_train_step(cfg, JTrain(**tc)))

    def batch(p, i):
        b = p.global_batch_at(i)
        return {"tokens": b["tokens"], "labels": b["labels"]}
    params0 = japi.init_model(cfg, 0)
    params, opt = params0, jadamw_init(params0)
    ck = JCheckpointer(tmp_path / "ref")
    want = []
    for i in range(4):
        if i == 2:
            ck.save(i, {"params": params, "opt": opt}, async_=False)
        params, opt, m = step(params, opt, batch(pipe, i), i)
        want.append(float(m["loss"]))
    state, _ = ck.restore(template={"params": params, "opt": opt})
    p2, o2 = state["params"], state["opt"]
    want_replay = []
    for i in range(2, 4):
        p2, o2, m = step(p2, o2, batch(pipe, i), i)
        want_replay.append(float(m["loss"]))
        assert abs(want_replay[-1] - want[i]) < REPLAY

    # the port, on the reference's initial weights
    tcfg = reduced_config(ARCHS[name])
    tpipe = TokenPipeline(tcfg.vocab_size, 32, 4, seed=1)
    tstep = tapi.make_train_step(tcfg, TrainConfig(**tc))
    params = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params0), device="cpu")
    opt = adamw_init(params)
    tck = Checkpointer(tmp_path / "port")
    got = []
    for i in range(4):
        b = batch(tpipe, i)
        for k, v in b.items():
            np.testing.assert_array_equal(v, batch(pipe, i)[k])
        if i == 2:
            tck.save(i, {"params": params, "opt": opt}, async_=False)
        params, opt, m = tstep(params, opt, b, i)
        got.append(float(m["loss"]))
    state, _ = tck.restore(template={"params": params, "opt": opt},
                           device="cpu")
    p2, o2 = state["params"], state["opt"]
    for j, i in enumerate(range(2, 4)):
        p2, o2, m = tstep(p2, o2, batch(tpipe, i), i)
        loss = float(m["loss"])
        assert abs(loss - got[i]) < REPLAY
        _close(loss, want_replay[j], LOSS_REL)
    for g_, w_ in zip(got, want):
        _close(g_, w_, LOSS_REL)


def test_serving_prefill_then_decode_loop():
    """Twin of test_system.py::test_serving_prefill_then_decode_loop:
    stablelm at reduced_config, a prefill of 2 x 16 tokens and four
    greedy steps in both packages on the reference's weights; each
    side's logits finite, the port's within LOGIT_REL of the reference's
    at the prefill and every step, the same greedy tokens, and `pos`
    S + 4 on both."""
    name = "stablelm-1.6b"
    cfg = jreduced(JARCHS[name])
    params = japi.init_model(cfg, 0)
    B, S = 2, 16
    batch = japi.concrete_batch(cfg, JShape("p", S, B, "prefill"), seed=5)
    cache_len = S + 8
    logits, cache = japi.make_prefill_fn(cfg, cache_len=cache_len)(params,
                                                                   batch)
    dec = jax.jit(japi.make_decode_fn(cfg))

    tcfg = reduced_config(ARCHS[name])
    tp = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    tlogits, tcache = tapi.make_prefill_fn(tcfg, cache_len=cache_len)(
        tp, batch)
    tdec = tapi.make_decode_fn(tcfg)
    _logits_close(tlogits, logits)
    toks = np.argmax(np.asarray(logits), -1).astype(np.int32)
    for _ in range(4):
        ttoks = torch.argmax(tlogits, -1).to(torch.int32)
        np.testing.assert_array_equal(ttoks.numpy(), toks)
        logits, cache = dec(params, cache, toks)
        tlogits, tcache = tdec(tp, tcache, ttoks)
        assert np.isfinite(np.asarray(logits)).all()
        assert bool(torch.isfinite(tlogits).all())
        _logits_close(tlogits, logits)
        toks = np.argmax(np.asarray(logits), -1).astype(np.int32)
    assert int(cache["pos"]) == int(tcache["pos"]) == S + 4

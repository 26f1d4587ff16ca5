"""The check must fail on runs of the harness with the timed path broken
underneath (the look for a card skipped: the CPU)."""
from pathlib import Path

import numpy as np
import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent.parent


def alter_a_row(res):
    if res.count:
        res.rows = res.rows.copy()
        res.rows[0, 0] = (res.rows[0, 0] + 1) % 1000
    return res


def drop_half(res):
    res.rows = res.rows[: res.count // 2]
    return res


def double(res):
    res.rows = np.concatenate([res.rows, res.rows])
    return res


def flag_as_cut(res):
    res.stats.truncated = True
    return res


def empty(res):
    res.rows = res.rows[:0]
    return res


FAULTS = {
    "a row altered where it is produced": ("engine", alter_a_row),
    "half of an answer left out, unflagged": ("engine", drop_half),
    "every answer empty": ("engine", empty),
    "every row served twice": ("engine", double),
    "every answer flagged as cut": ("engine", flag_as_cut),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
def test_a_broken_engine_is_not_correct(tiny_cell, monkeypatch, fault,
                                        name):
    from repro_torch.core.engine import Engine
    _, fn = FAULTS[fault]
    inner = Engine.execute_prepared

    def broken(self, pq, *a, **k):
        return fn(inner(self, pq, *a, **k))

    monkeypatch.setattr(Engine, "execute_prepared", broken)
    out = harness.run_cell(ROOT, name, 21, 1.0, False, device="cpu",
                           cell=tiny_cell(name))
    assert out["correct"] is False
    assert out["checks"]["mismatched_answers"]["value"] > 0


@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
def test_a_sound_run_with_cut_answers_is_correct(tiny_cell, name):
    """At max_rows 64 a run cuts most answers, and the cut answers pass."""
    cell = tiny_cell(name)
    cell.config["max_rows"] = 64
    out = harness.run_cell(ROOT, name, 25, 1.0, False, device="cpu",
                           cell=cell)
    assert out["correct"] is True, out["notes"]
    assert out["notes"]["cut_answers_checked"] > 0


@pytest.mark.parametrize("fault", ["every row served twice",
                                   "a row altered where it is produced"])
def test_a_broken_engine_is_not_correct_on_cut_answers(tiny_cell,
                                                       monkeypatch, fault):
    """The same faults on flagged answers alone, at max_rows 64."""
    from repro_torch.core.engine import Engine
    _, fn = FAULTS[fault]
    inner = Engine.execute_prepared

    def broken(self, pq, *a, **k):
        res = inner(self, pq, *a, **k)
        return fn(res) if res.stats.truncated else res

    monkeypatch.setattr(Engine, "execute_prepared", broken)
    cell = tiny_cell("lubm1.replay")
    cell.config["max_rows"] = 64
    out = harness.run_cell(ROOT, "lubm1.replay", 26, 1.0, False,
                           device="cpu", cell=cell)
    assert out["correct"] is False
    assert out["notes"]["cut_answers_checked"] > 0


@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
def test_fan_out_without_renumbering_is_not_correct(tiny_cell, monkeypatch,
                                                    name):
    """Every client gets the rows in the plan's canonical node order."""
    import repro_torch.serve.server as server
    monkeypatch.setattr(server, "remap_result",
                        lambda res, order: res)
    out = harness.run_cell(ROOT, name, 22, 1.0, False, device="cpu",
                           cell=tiny_cell(name))
    assert out["correct"] is False


def test_half_of_each_flush_answered_from_another_bucket(tiny_cell,
                                                          monkeypatch):
    """The batcher hands half of its items another bucket's result."""
    from repro_torch.serve.batching import ShapeBatcher
    inner = ShapeBatcher.flush

    def broken(self, execute, should_stop=None):
        out = inner(self, execute, should_stop)
        half = len(out) // 2
        return [(item, out[-1][1]) if k < half else (item, res)
                for k, (item, res) in enumerate(out)]

    monkeypatch.setattr(ShapeBatcher, "flush", broken)
    out = harness.run_cell(ROOT, "lubm1.replay", 23, 1.0, False,
                           device="cpu", cell=tiny_cell("lubm1.replay"))
    assert out["correct"] is False


def test_a_request_that_fails_is_not_correct(tiny_cell, monkeypatch):
    from repro_torch.core.engine import Engine
    inner = Engine.execute_prepared
    calls = []

    def failing(self, pq, *a, **k):
        calls.append(1)
        if len(calls) % 7 == 0:
            raise RuntimeError("injected")
        return inner(self, pq, *a, **k)

    monkeypatch.setattr(Engine, "execute_prepared", failing)
    out = harness.run_cell(ROOT, "lubm1.fresh", 24, 1.0, False,
                           device="cpu", cell=tiny_cell("lubm1.fresh"))
    assert out["correct"] is False
    assert out["checks"]["failed_requests"]["value"] > 0
    assert out["failed"] == out["checks"]["failed_requests"]["value"]

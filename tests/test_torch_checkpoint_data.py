"""repro_torch.checkpoint.Checkpointer and repro_torch.data.TokenPipeline:
twins of tests/test_checkpoint_data.py (atomicity, integrity, retention,
the deterministic pipeline), run on the port, and the port against the
reference: the pipeline's arrays equal the reference's exactly, a
checkpoint written by either package restores in the other, bf16 leaves
round-trip bit for bit, and an asynchronous save holds the values of the
moment it was called, whatever the train loop writes in place after."""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data.lm_data import TokenPipeline as JTokenPipeline
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.tree import tree_leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 8)).astype(np.float32),
            "b": {"w": rng.normal(size=(3,)).astype(np.float32),
                  "step": np.int32(7)}}


def _torch_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.normal(size=(5, 6)).astype(np.float32)),
                       "h": torch.from_numpy(rng.normal(size=(7,)).astype(
                           np.float32)).to(torch.bfloat16)},
            "opt": {"m": torch.zeros(5, 6), "step": torch.tensor(
                3, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    g = dict(tree_leaves(got))
    w = dict(tree_leaves(want))
    assert set(g) == set(w)
    for path, a in w.items():
        b = g[path]
        if torch.is_tensor(a):
            assert b.dtype == a.dtype and torch.equal(b, a), path
        else:
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=path)


# ---------------------------------------------------------------------- #
# twins of tests/test_checkpoint_data.py
# ---------------------------------------------------------------------- #
def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(10, t, meta={"cfg": "x"}, async_=False)
    out, meta = ck.restore(template=t, device="cpu")
    assert meta == {"cfg": "x"}
    np.testing.assert_array_equal(out["a"], t["a"])
    np.testing.assert_array_equal(out["b"]["w"], t["b"]["w"])


def test_async_save_and_latest(tmp_path):
    ck = Checkpointer(tmp_path)
    for s in (1, 2, 3):
        ck.save(s, _tree(s))
    ck.wait()
    assert ck.latest_step() == 3


def test_retention_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in range(5):
        ck.save(s, _tree(s), async_=False)
    assert ck.all_steps() == [3, 4]


def test_corruption_detected(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), async_=False)
    d = next(p for p in tmp_path.iterdir() if p.name.startswith("step_"))
    victim = next(p for p in d.iterdir() if p.suffix == ".npy")
    arr = np.load(victim)
    arr_flat = arr.reshape(-1)
    arr_flat[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError):
        ck.restore(template=_tree(), device="cpu")


def test_tmp_dir_never_visible(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _tree(), async_=False)
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_pipeline_deterministic():
    p = TokenPipeline(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    a = p.global_batch_at(5)
    b = p.global_batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.global_batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_shards_cover_global():
    p = TokenPipeline(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    g = p.global_batch_at(2)
    parts = [p.shard_at(2, i, 4)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), g["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    p = TokenPipeline(vocab_size=50, seq_len=8, global_batch=2, seed=0)
    b = p.global_batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------- #
# the port against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 16, 8, 3), (151_936, 64, 4, 0), (50, 8, 2, 11)])
def test_pipeline_matches_reference(vocab, seq, batch, seed):
    """Every array of every (step, shard) equals the reference's, exactly:
    global batches, shards and the encoder's masks."""
    got = TokenPipeline(vocab, seq, batch, seed=seed)
    want = JTokenPipeline(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7, 1000, 2 ** 20 + 3):
        for k, v in want.global_batch_at(step).items():
            a = got.global_batch_at(step)[k]
            assert a.dtype == v.dtype == np.int32
            np.testing.assert_array_equal(a, v)
        for n in (1, 2, batch):
            for shard in range(n):
                for k, v in want.shard_at(step, shard, n).items():
                    np.testing.assert_array_equal(
                        got.shard_at(step, shard, n)[k], v)
        for prob in (0.08, 0.5):
            np.testing.assert_array_equal(got.mask_at(step, prob),
                                          want.mask_at(step, prob))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint written by the reference (fp32 and int32 leaves) is
    read by the port: same keys, values and dtypes, crc32 verified, with
    and without a template."""
    t = _tree(4)
    JCheckpointer(tmp_path).save(3, t, meta={"step": 3}, async_=False)
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() == 3
    out, meta = ck.restore(template=t, device="cpu")
    assert meta == {"step": 3}
    assert out["b"]["step"].dtype == torch.int32
    assert int(out["b"]["step"]) == 7
    for path, a in tree_leaves(t):
        b = dict(tree_leaves(out))[path]
        assert torch.is_tensor(b) and b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), a)
    flat, _ = ck.restore(3, device="cpu")
    assert set(flat) == {"a", "b/w", "b/step"}


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port writes the reference's layout: its fp32 and int32 leaves
    restore in the reference's Checkpointer."""
    t = _torch_tree(1)
    del t["params"]["h"]                       # the reference has no bf16
    Checkpointer(tmp_path).save(8, t, meta={"step": 8}, async_=False)
    out, meta = JCheckpointer(tmp_path).restore(
        template={"params": {"w": 0}, "opt": {"m": 0, "step": 0}})
    assert meta == {"step": 8}
    for path, a in tree_leaves(t):
        np.testing.assert_array_equal(np.asarray(dict(
            tree_leaves(out))[path]), a.numpy())


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """bf16 leaves are stored as their uint16 bits ("dtype": "bfloat16" in
    the manifest) and restored bit for bit, NaN, inf and -0.0 included."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32)) \
        .to(torch.bfloat16)
    h[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    t = {"h": h, "w": torch.ones(3)}
    ck = Checkpointer(tmp_path)
    ck.save(1, t, async_=False)
    out, _ = ck.restore(template=t, device="cpu")
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"].view(torch.int16), h.view(torch.int16))
    manifest = json.loads((tmp_path / "step_0000000001" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_0000000001" / "h.npy").dtype == np.uint16


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path):
    """save copies every leaf before it returns: an AdamW-style in-place
    update right after an asynchronous save leaves the checkpoint with the
    values of the moment save was called (a tensor's .numpy() on the CPU
    would share its storage)."""
    t = _torch_tree(2)
    want = {p: x.clone() for p, x in tree_leaves(t)}
    ck = Checkpointer(tmp_path)
    ck.save(4, t)
    for _, x in tree_leaves(t):
        x.add_(1)
    ck.wait()
    out, _ = ck.restore(template=t, device="cpu")
    for path, x in tree_leaves(out):
        assert x.dtype == want[path].dtype
        assert torch.equal(x, want[path]), path
        assert not torch.equal(x, dict(tree_leaves(t))[path]), path


def test_restore_on_a_device_and_missing_leaves(tmp_path):
    t = _torch_tree(3)
    ck = Checkpointer(tmp_path)
    ck.save(2, t, async_=False)
    out, _ = ck.restore(template=t, device="cpu")
    _assert_tree_equal(out, t)
    with pytest.raises(KeyError):
        ck.restore(template={**t, "extra": torch.zeros(1)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    """restore() without device= puts the leaves on the card; without CUDA
    it raises rather than restore onto the CPU (a resumed run would
    train there)."""
    t = _torch_tree(4)
    ck = Checkpointer(tmp_path)
    ck.save(6, t, async_=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.restore(template=t)
        return
    out, _ = ck.restore(template=t)
    want = dict(tree_leaves(t))
    for path, x in tree_leaves(out):
        assert x.device.type == "cuda", path
        assert x.dtype == want[path].dtype
        assert torch.equal(x.cpu(), want[path]), path


def test_failed_async_write_is_raised_by_wait(tmp_path, monkeypatch):
    """An exception of the writer thread is not lost: wait() raises it,
    and no step becomes visible."""
    def full_disk(*a, **k):
        raise OSError("no space left on device")
    monkeypatch.setattr(np, "save", full_disk)
    ck = Checkpointer(tmp_path)
    ck.save(1, _torch_tree(0))
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    assert ck.all_steps() == []
    ck.wait()                                  # raised once

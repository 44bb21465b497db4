"""The port's checkpoints, case for case the reference's
(``tests/test_data_checkpoint.py`` and ``tests/test_guardian.py``'s
integrity cases): roundtrip, keep the latest K, async writes, a crash
mid-write ignored, a shape mismatch raising, crc32 catching bit rot with
the fallback to the newest step that verifies, a step without a manifest
not complete, all steps corrupt raising; plus what the port adds: bf16
leaves, ``drop``/``allow_missing``, the writer thread's errors, and the
two packages reading each other's files (the same format)."""
import os
import threading

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.train.chaos import corrupt_checkpoint
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _complete_steps
import torch_threads  # noqa: F401  (the worker's share of the cores)


def _tree(x=0.0):
    return {"w": torch.full((4, 3), 1.0 + x),
            "n": np.arange(5) + int(x)}


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"mom": torch.ones((3, 4)), "count": np.int32(5)}}
    ckpt.save(str(tmp_path), 10, tree)
    step, restored = ckpt.restore(str(tmp_path), tree)
    assert step == 10
    assert torch.equal(restored["w"], tree["w"])
    assert restored["opt"]["count"].dtype == np.int32
    np.testing.assert_array_equal(restored["opt"]["count"], 5)


def test_checkpoint_keeps_latest_k(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in [1, 2, 3, 4]:
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_checkpoint_async(tmp_path):
    tree = {"x": torch.full((1000,), 3.0)}
    t = ckpt.save(str(tmp_path), 1, tree, async_write=True)
    assert isinstance(t, threading.Thread)
    t.join(timeout=30)
    assert not t.is_alive()
    step, restored = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(restored["x"], tree["x"])


def test_checkpoint_async_snapshot_and_errors(tmp_path, monkeypatch):
    """The host copy is taken before save returns (an in-place update made
    before the writer writes does not reach the file), and a failed write
    raises from the writer's join."""
    written = threading.Event()
    savez = np.savez

    def held_savez(*a, **k):  # the writer waits until x has changed
        assert written.wait(30)
        return savez(*a, **k)

    monkeypatch.setattr(np, "savez", held_savez)
    x = torch.zeros(8)
    t = ckpt.save(str(tmp_path), 1, {"x": x}, async_write=True)
    x.add_(1.0)
    written.set()
    t.join(timeout=30)
    monkeypatch.setattr(np, "savez", savez)
    assert torch.equal(ckpt.restore(str(tmp_path), {"x": x})[1]["x"],
                       torch.zeros(8))
    (tmp_path / "step_00000002.tmp").write_text("")  # not a directory
    t = ckpt.save(str(tmp_path), 2, {"x": x}, async_write=True)
    with pytest.raises(OSError):
        t.join(timeout=30)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_crash_mid_write_is_ignored(tmp_path):
    """A stale .tmp dir (a simulated crash) must not break restore."""
    tree = {"x": torch.ones(4)}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    step, _ = ckpt.restore(str(tmp_path), tree)
    assert step == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"x": torch.ones((3, 3))})


def test_checkpoint_crc_detects_bit_rot(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, _tree(0.0))
    ckpt.save(d, 4, _tree(1.0))
    assert ckpt.verify_step(d, 4)
    corrupt_checkpoint(d, 4)
    assert not ckpt.verify_step(d, 4)
    assert ckpt.verify_step(d, 2)
    # newest-valid fallback: restore(None) lands on step 2...
    step, out = ckpt.restore(d, _tree())
    assert step == 2
    assert torch.equal(out["w"], _tree(0.0)["w"])
    # ...but an explicitly requested corrupt step must raise
    with pytest.raises(ValueError, match="crc32"):
        ckpt.restore(d, _tree(), step=4)


def test_checkpoint_without_manifest_is_not_complete(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, _tree())
    os.remove(os.path.join(d, "step_00000002", "MANIFEST"))
    assert _complete_steps(d) == []
    assert ckpt.latest_step(d) is None


def test_checkpoint_all_corrupt_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, _tree())
    corrupt_checkpoint(d, 2)
    with pytest.raises(FileNotFoundError, match="uncorrupted"):
        ckpt.restore(d, _tree())


def test_bf16_leaves_drop_and_allow_missing(tmp_path):
    """bf16 leaves round-trip exactly (stored as fp32); a dropped key is
    left out of the file and kept from the target on restore."""
    d = str(tmp_path)
    b = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"opt": {"w": {"ortho": b, "ortho_p": torch.ones(2)}}}
    ckpt.save(d, 1, tree, drop={"ortho_p"})
    with np.load(os.path.join(d, "step_00000001", "tree.npz")) as data:
        assert data.files == ["opt|w|ortho"]
        assert data["opt|w|ortho"].dtype == np.float32
    target = {"opt": {"w": {"ortho": torch.zeros(5, 3, dtype=torch.bfloat16),
                            "ortho_p": torch.full((2,), 7.0)}}}
    _, out = ckpt.restore(d, target, allow_missing={"ortho_p"})
    assert out["opt"]["w"]["ortho"].dtype == torch.bfloat16
    assert torch.equal(out["opt"]["w"]["ortho"], b)
    assert torch.equal(out["opt"]["w"]["ortho_p"], torch.full((2,), 7.0))
    with pytest.raises(KeyError):
        ckpt.restore(d, target)


def test_same_format_as_the_reference(tmp_path):
    """Each package restores the other's checkpoint, crc32 included."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    jckpt.save(a, 3, {"params": {"w": w}, "opt": {"count": np.int32(3)}})
    step, out = ckpt.restore(a, {"params": {"w": torch.zeros(3, 4)},
                                 "opt": {"count": np.int32(0)}})
    assert step == 3 and torch.equal(out["params"]["w"],
                                     torch.from_numpy(w))
    ckpt.save(b, 5, {"params": {"w": torch.from_numpy(w)}})
    assert jckpt.verify_step(b, 5)
    step, jout = jckpt.restore(b, {"params": {"w": np.zeros((3, 4),
                                                             np.float32)}})
    assert step == 5
    np.testing.assert_array_equal(np.asarray(jout["params"]["w"]), w)


@pytest.mark.parametrize("nbytes", [0, 1, 63, 64, 65, 256, 1000])
def test_chunked_crc_is_zlibs(monkeypatch, nbytes):
    """A leaf of more than one chunk is taken a chunk a thread and the
    chunks' crcs combined: the result is ``zlib.crc32`` of its bytes."""
    import zlib

    from repro_torch.checkpoint import checkpoint as ck

    monkeypatch.setattr(ck, "_CRC_CHUNK", 64)
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                 dtype=np.uint8)
    assert ck._crc(raw) == zlib.crc32(raw.tobytes())
    # a strided float view: its contiguous bytes
    arr = np.arange(3 * nbytes, dtype=np.float32).reshape(3, -1)[:, ::2]
    assert ck._crc(arr) == zlib.crc32(np.ascontiguousarray(arr).tobytes())


def test_chunked_crc_manifest_reads_in_the_reference(tmp_path, monkeypatch):
    """A checkpoint whose leaves span many chunks verifies in the JAX
    package, and the reference's in the port."""
    from repro_torch.checkpoint import checkpoint as ck

    monkeypatch.setattr(ck, "_CRC_CHUNK", 256)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    w = np.random.default_rng(0).standard_normal((37, 29)).astype(np.float32)
    ckpt.save(a, 1, {"w": torch.from_numpy(w)})
    assert jckpt.verify_step(a, 1)
    jckpt.save(b, 2, {"w": w})
    assert ckpt.verify_step(b, 2)
    corrupt_checkpoint(b, 2)
    assert not ckpt.verify_step(b, 2)

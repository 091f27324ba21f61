"""The checkpoint index survives a write cut short, on the CPU: the index
(``checkpoints.json``) is written to a temporary file and put in place
whole (``checkpoint/checkpointer.py``), so a save that fails while writing
it leaves the previous index readable and ``kept()`` unchanged, as another
rank reading it at that moment sees it."""

import json

import pytest
import torch

from ape_tpu_torch.checkpoint import checkpointer as ckpt


class _Interrupted(RuntimeError):
    pass


@pytest.mark.parametrize("keep", (1, 2, 3))
def test_index_write_cut_short_keeps_the_previous_index(tmp_path, monkeypatch, keep):
    c = ckpt.Checkpointer(str(tmp_path), keep=keep)
    for step in (10, 20, 30):
        c.save(step, {"w": torch.full((3,), float(step))})
    before = c.kept()
    assert before == [f"model_{s:07d}.pth" for s in (10, 20, 30)][-keep:]
    real_dump = json.dump

    def dump_half_then_fail(obj, f, *args, **kwargs):
        text = json.dumps(obj)
        f.write(text[:len(text) // 2])  # a partial write, then the failure
        f.flush()
        raise _Interrupted("the index write was cut short")

    monkeypatch.setattr(ckpt.json, "dump", dump_half_then_fail)
    with pytest.raises(_Interrupted):
        c.save(40, {"w": torch.full((3,), 40.0)})
    monkeypatch.setattr(ckpt.json, "dump", real_dump)
    with open(tmp_path / "checkpoints.json") as f:
        assert [tuple(e) for e in json.load(f)] == [
            (s, f"model_{s:07d}.pth") for s in (10, 20, 30)][-keep:]
    assert c.kept() == before
    assert c.latest_step() == 30
    assert ckpt.Checkpointer(str(tmp_path), keep=keep).kept() == before

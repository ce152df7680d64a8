"""The comparison that decides ``correct`` catches the faults a served
cell can have.  Each test skips the harness's look for a card and drives
a whole run on the CPU with the timed path broken underneath: the
executor's window output altered before the answers are split off."""

import pytest

from band_tpu_torch.backend import executor as ex_mod
from portbench import harness

CELL = "sr_tiny.stream_tiny"


def _break(monkeypatch, fault):
    run = ex_mod.ModelExecutor._run
    last = {}

    def broken(self, key, args):
        outs = [o.clone() for o in run(self, key, args)]
        o = outs[0]
        if fault == "altered" and o.numel():
            # one byte of the window's first answer, where it is produced
            flat = o.view(-1)
            flat[0] = flat[0] + 1 if flat[0] < 127 else flat[0] - 1
        elif fault == "half_left_out" and o.shape[0] >= 2:
            # the window's second half gets the first half's answers
            h = o.shape[0] // 2
            o[h:2 * h] = o[:h]
        elif fault == "unchanged":
            # the window hands back what the last window of its size made
            prev = last.get(tuple(o.shape))
            last[tuple(o.shape)] = [t.clone() for t in outs]
            if prev is not None:
                outs = prev
        return outs

    monkeypatch.setattr(ex_mod.ModelExecutor, "_run", broken)


def test_sound_run_is_correct(tiny_root):
    r = harness.run_cell(tiny_root, CELL, 2**31 + 11, 1.0, False, "cpu", 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "unchanged"])
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    _break(monkeypatch, fault)
    r = harness.run_cell(tiny_root, CELL, 2**31 + 12, 1.0, False, "cpu", 0.0)
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] > 0
    assert r["checks"]["max_abs_diff"]["value"] > 0


def test_video_cell_fault(tiny_root, monkeypatch):
    _break(monkeypatch, "altered")
    r = harness.run_cell(tiny_root, "sr_tiny.video_tiny", 5, 1.0, False,
                         "cpu", 0.0)
    assert not r["correct"]


def test_result_has_the_contract_keys(tiny_root):
    r = harness.run_cell(tiny_root, "sr_tiny.video_tiny", 2**31 + 13, 1.0,
                         False, "cpu", 0.0)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"p50_ms", "p95_ms", "setup_s"}
    assert all(c["limit"] == 0 for c in r["checks"].values())

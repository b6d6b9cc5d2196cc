"""A whole run without the look for a card (CPU, tiny sizes, the port in
float32): sound, `correct` comes out true; with the timed path broken
underneath, false, once for each fault the cell can have."""

import pytest

from rrbench import harness

from conftest import tiny_cell


def _correct(cell):
    rec = cell.driver().run(cell)
    judged = harness.judge(rec["numbers"], cell.limits)
    return rec["failed"] == 0 and all(j["ok"] for j in judged.values()), \
        rec["numbers"]


def _altered(rows_list):
    """Each answer's boxes moved by their own width and its classes
    changed, where they are produced."""
    out = []
    for rows in rows_list:
        rows = rows.copy()
        rows[:, 0] += rows[:, 2] + 8.0
        rows[:, 5] = rows[:, 5] % 10 + 1
        out.append(rows)
    return out


@pytest.mark.parametrize("workload", ["rrnet-eval6", "hrnet_attn-eval6"])
def test_sound_detection_run_is_correct(workload):
    ok, numbers = _correct(tiny_cell(workload))
    assert ok, numbers


@pytest.mark.parametrize("workload", ["rrnet-eval6", "hrnet_attn-eval6"])
def test_altered_answers_are_not_correct(workload, monkeypatch):
    from rrnet_torch.evallib.infer import Evaluator
    inner = Evaluator.collect
    monkeypatch.setattr(Evaluator, "collect",
                        lambda self, h: _altered(inner(self, h)))
    ok, numbers = _correct(tiny_cell(workload))
    assert not ok, numbers


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Eval: the second half of each batch answered with the first
    half's images."""
    from rrnet_torch.evallib.infer import Evaluator
    inner = Evaluator.stage

    def stage(self, images):
        k = len(images) // 2
        return inner(self, images[:k] * 2)

    monkeypatch.setattr(Evaluator, "stage", stage)
    ok, numbers = _correct(tiny_cell("rrnet-eval6"))
    assert not ok, numbers


def test_answers_given_to_other_frames_are_not_correct(monkeypatch):
    """Each batch's answers handed out one frame along."""
    from rrnet_torch.evallib.infer import Evaluator
    inner = Evaluator.collect

    def collect(self, h):
        out = inner(self, h)
        return out[1:] + out[:1]

    monkeypatch.setattr(Evaluator, "collect", collect)
    ok, numbers = _correct(tiny_cell("rrnet-eval6"))
    assert not ok, numbers


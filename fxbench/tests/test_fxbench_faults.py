"""A run with the timed path broken underneath comes out not correct.

Each cell runs as the benchmark runs it, past the look for a card, on the
program's CPU route at the CPU's size, once sound and once with each
fault a cell of one card can have planted in the step the program builds
(``fxtpu_torch.fx.make_fx_step``, which the engine's K-block call also
runs block by block on this route): the state returned unchanged, half of
the block's frames left out and the mean taken over the rest, and an
answer altered where it is produced.  No cell has an exchange between
chips to leave out."""

import pytest

from fxbench.run import result_line
from fxbench.tests.conftest import tiny_cell

CELLS = ["effex2.live_spectrum", "array8.engine_int8"]


def state_unchanged(step):
    def faulty(iq, delays, history):
        vis, _ = step(iq, delays, history)
        return vis, history
    return faulty


def half_batch(step):
    def faulty(iq, delays, history):
        return step(iq[:, : iq.shape[1] // 2], delays, history)
    return faulty


def altered_answer(step):
    def faulty(iq, delays, history):
        vis, history = step(iq, delays, history)
        vis = vis.clone()
        vis.view(-1)[0] *= -1
        return vis, history
    return faulty


FAULTS = {"none": None, "state_unchanged": state_unchanged,
          "half_batch": half_batch, "altered_answer": altered_answer}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    import fxtpu_torch.fx as fx
    if FAULTS[fault] is not None:
        make = fx.make_fx_step

        def make_faulty(**kw):
            return FAULTS[fault](make(**kw))

        monkeypatch.setattr(fx, "make_fx_step", make_faulty)
    cell = tiny_cell(workload)
    out = cell.driver.run(cell, seed=2**31 + 101, seconds=1.5, trace=False,
                          device="cpu")
    line = result_line(cell, out, False, {}, 1.0)
    assert line["correct"] is (fault == "none"), line["checks"]

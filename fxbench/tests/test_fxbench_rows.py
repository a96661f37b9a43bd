"""The product CSV's rows as the harness reads them: the follower's byte
spans and times, the parser, and the live cell's mapping of rows to the
blocks the receivers delivered, a lost block among them."""

import io
import threading
import time

import numpy as np
import pytest

from fxbench.drivers.live import PacedSource, block_latencies
from fxbench.follower import RowFollower
from fxbench.reference.rows import parse_row, read_rows


def _row(values) -> bytes:
    fh = io.StringIO()
    np.savetxt(fh, [np.asarray(values, np.complex128)], delimiter=",")
    return fh.getvalue().encode()


def test_follower_stamps_whole_rows_after_the_header(tmp_path):
    path = str(tmp_path / "vis.csv")
    fol = RowFollower(path, header_lines=2, poll=0.001).start()
    rows = [_row(np.arange(5) + 1j * k) for k in range(4)]
    with open(path, "wb") as fh:
        fh.write(b"mode:SPECTRUM\n1,2,3\n")
        fh.flush()
        for r in rows[:2]:
            fh.write(r)
            fh.flush()
        half = len(rows[2]) // 2
        fh.write(rows[2][:half])          # a row half written
        fh.flush()
        assert fol.wait_rows(2, timeout=5.0) is not None
        time.sleep(0.02)
        assert len(fol.rows) == 2
        t_half = time.perf_counter()
        fh.write(rows[2][half:] + rows[3])
        fh.flush()
        assert fol.wait_rows(4, timeout=5.0) >= t_half
    fol.stop()
    spans = [(a, b) for a, b, _ in fol.rows]
    got = read_rows(path, spans)
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, np.arange(5) + 1j * k)
    times = [t for _, _, t in fol.rows]
    assert times == sorted(times)


def test_parse_row_reads_savetxt_lines_and_blocks_of_them():
    vals = np.array([1.5 - 2e-7j, -3.25e10 + 0j, 1e-30 + 7j])
    np.testing.assert_array_equal(parse_row(_row(vals)), vals)
    two = _row(vals) + _row(vals[::-1])
    np.testing.assert_array_equal(parse_row(two),
                                  np.concatenate([vals, vals[::-1]]))
    with pytest.raises(ValueError):
        parse_row(b"\n")


def test_rows_map_to_delivered_blocks_past_a_lost_one():
    """Block 0 calibrates; blocks 3 and 4 were lost in the receivers'
    queue, so rows follow blocks 1, 2, 5, 6; block 7 has no row yet."""
    delivered = [0, 1, 2, 5, 6, 7]
    row_times = [11.5, 12.5, 15.6, 16.5]          # rows of 1, 2, 5, 6

    def due(i):
        return 10.0 + i

    latency, failed, rows = block_latencies(
        [1, 2, 3, 4, 5, 6, 7], delivered, row_times, due, stopped=20.0)
    assert failed == 3                            # 3, 4 lost; 7 unwritten
    assert rows == [0, 1, 2, 3]
    np.testing.assert_allclose(latency,
                               [0.5, 0.5, 7.0, 6.0, 0.6, 0.5, 3.0])


def test_paced_source_keeps_its_schedule_and_loses_what_it_cannot_hold():
    num, rate = 64, 64 / 0.02                    # a block every 20 ms
    rec = (np.arange(4 * num, dtype=np.complex64) * np.ones((2, 1))
           ).astype(np.complex64)
    src = PacedSource(rec, num, rate, 1.4e9, 0.0, queue_blocks=2)
    blocks = [src.read_block(num) for _ in range(3)]
    for i, (b, r) in enumerate(zip(blocks, src.returned)):
        assert r >= src.due(i)
        assert r - src.due(i) < 0.015
        np.testing.assert_array_equal(b, rec[:, i * num:(i + 1) * num])
    time.sleep(0.02 * 6)                          # the reader falls behind
    src.read_block(num)
    assert src.lost and src.delivered[-1] == src.lost[-1] + 1
    assert src.delivered[-1] >= 3 + len(src.lost)
    src.end_time = src.due(src._next) - 1e-3
    assert src.read_block(num) is None            # nothing due after the end
    stopper = PacedSource(rec, num, rate / 100, 1.4e9, 0.0, queue_blocks=2)
    threading.Timer(0.05, stopper.stop).start()
    t = time.perf_counter()
    assert stopper.read_block(num) is None        # a stop wakes a wait
    assert time.perf_counter() - t < 1.0


def test_a_live_run_that_loses_blocks_is_not_correct(monkeypatch):
    """The feeder stalls once, longer than the receivers' queue holds: the
    blocks lost there get no row, and the run is not correct although
    every row it wrote is."""
    from fxbench.run import result_line
    from fxbench.tests.conftest import tiny_cell
    read = PacedSource.read_block
    stalled = []

    def read_with_a_stall(self, num_samp):
        if (not stalled and self.t_start is not None
                and time.perf_counter() - self.t_start > 0.6):
            stalled.append(True)
            time.sleep(self.period * (self.queue_blocks + 4))
        return read(self, num_samp)

    monkeypatch.setattr(PacedSource, "read_block", read_with_a_stall)
    cell = tiny_cell("effex2.live_spectrum")
    out = cell.driver.run(cell, seed=2**31 + 7, seconds=1.5, trace=False,
                          device="cpu")
    line = result_line(cell, out, False, {}, 1.0)
    checks = line["checks"]
    assert out.failed > 0 and checks["failed_blocks"]["value"] == out.failed
    assert checks["row_gap"]["value"] <= checks["row_gap"]["limit"]
    assert line["correct"] is False

"""The mean time from ``BlockAligner.get`` handing a block over to the
writer starting its row: the step's enqueue, the queue, and the writer's
0.1 s poll, over the rows of the window's blocks."""


def read(record):
    waits = record.counters.get("row_waits_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)

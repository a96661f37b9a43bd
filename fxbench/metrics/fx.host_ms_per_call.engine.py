"""The host's time a ``multi_step`` call: the harness's span around each
call of its engine loop in the traced part of the window."""


def read(record):
    spans = record.spans.get("fx.multi_step")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)

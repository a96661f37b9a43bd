"""The writer's time a block's rows: the harness's span around
``products.append_visibility`` (the copy to the host and the text), per
call, over the window."""


def read(record):
    spans = record.spans.get("products.append_visibility")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)

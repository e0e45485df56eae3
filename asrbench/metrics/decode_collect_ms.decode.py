"""Mean host ms of ``decode_collect`` (the n-best's copies to the host and
the id -> word mapping), timed once the call's device work has ended."""


def read(run):
    s = run.spans.get("decode_collect")
    return 1e3 * sum(s) / len(s) if s else None

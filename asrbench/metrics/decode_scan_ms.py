"""Device ms a decode call of the program's ``decode.scan`` span: the
frame scan of the call (``DeviceBeamDecoder._scan``, the carry's seed
included), timed by the span's CUDA events, summed over the window and
divided by the window's ``decode.dispatch`` records (one a call)."""

from asrbench.harness.spans import records


def read(run):
    recs, calls = records("decode.scan"), records("decode.dispatch")
    if not recs or not calls:
        return None
    return sum(r.device_ms for r in recs) / len(calls)

"""Device ms a decode call of the program's ``decode.score`` span: the
GMM scoring of the call's frames (``DeviceBeamDecoder._scores``), timed
by the span's CUDA events, summed over the window and divided by the
window's ``decode.dispatch`` records (one a call)."""

from asrbench.harness.spans import records


def read(run):
    recs, calls = records("decode.score"), records("decode.dispatch")
    if not recs or not calls:
        return None
    return sum(r.device_ms for r in recs) / len(calls)

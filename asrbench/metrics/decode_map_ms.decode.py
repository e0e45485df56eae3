"""Mean host ms a decode call of the program's ``decode.map`` span: the
id -> word mapping on the host (``DeviceBeamDecoder._to_hypotheses``)."""

from asrbench.harness.spans import mean_host_ms


def read(run):
    return mean_host_ms("decode.map")

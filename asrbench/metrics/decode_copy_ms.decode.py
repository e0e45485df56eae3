"""Mean host ms a decode call of the program's ``decode.copy`` span: the
n-best's two copies to the host in ``DeviceBeamDecoder.decode_collect``,
with any wait for the call's device work."""

from asrbench.harness.spans import mean_host_ms


def read(run):
    return mean_host_ms("decode.copy")

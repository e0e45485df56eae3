"""Decoder tier: frame-synchronous Viterbi-beam token passing on the host
(the simple and vectorized tiers) and the device graph-Viterbi decoder."""

from poccala_tpu_torch.decoder.beam import BeamDecoder, Hypothesis
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder

__all__ = ["BeamDecoder", "DeviceBeamDecoder", "Hypothesis"]

"""Decoder tier: the device graph-Viterbi decoder."""

from poccala_tpu_torch.decoder.beam import Hypothesis
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder

__all__ = ["DeviceBeamDecoder", "Hypothesis"]

"""Batched decode serving.

:class:`DecodeService` is framework-free — it only calls the decoder's
``decode_dispatch`` / ``decode_collect`` — so the port reuses the JAX
package's implementation as it is.  With the port's
:class:`~poccala_tpu_torch.decoder.device.DeviceBeamDecoder`, dispatch
enqueues the scoring kernel and the frame loop on the current CUDA stream
and collect synchronises by copying the n-best arrays to the host.
"""

from poccala_tpu.serve import DecodeService

__all__ = ["DecodeService"]

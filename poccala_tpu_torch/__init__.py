"""poccala_tpu_torch — the PyTorch/CUDA port of ``poccala_tpu``.

The package mirrors the JAX package's module paths
(``poccala_tpu/ops/frontend.py`` <-> ``poccala_tpu_torch/ops/frontend.py``)
and is held against it by the ``tests/test_torch_*.py`` parity tests.  It
imports ``torch``, never ``jax`` and nothing of the JAX package: the
framework-free modules it needs from there (``config``, ``io.wav``,
``io.audio_device``, ``lm.ngram``, ``native``, ``serve``, the command
line's parser) and the host NumPy code that sits behind a jax import there
are its own copies, pinned to the originals by ``tests/test_torch_copies.py``
and ``tests/test_torch_lexicon.py``.  Its entry points put their state on
the card unless the caller passes ``device="cpu"``
(:mod:`~poccala_tpu_torch.utils.device`).

Ported: everything the JAX package does, on one card or a one-card
process group —

* decode serving — WAV -> MFCC frontend -> VAD ->
  :class:`~poccala_tpu_torch.serve.DecodeService` ->
  :class:`~poccala_tpu_torch.decoder.device.DeviceBeamDecoder` (exact or
  block-pruned search, streaming), and the host decoder tiers
  (:class:`~poccala_tpu_torch.decoder.vector.VectorBeamDecoder`, the
  command line's default, and :class:`~poccala_tpu_torch.decoder.beam.
  BeamDecoder`); the GMM scoring of every tier runs hand-written CUDA
  kernels (``csrc/gmm_score.cu``: exact float32 FMA, and bfloat16 on the
  tensor cores);
* scheme-2 training — corpus batching, flat start, embedded Baum-Welch
  (:mod:`~poccala_tpu_torch.train.accumulators`), Viterbi forced
  alignment and :class:`~poccala_tpu_torch.train.trainer.Trainer`, whose
  sentence scoring and banded forward / backward / Viterbi run
  hand-written CUDA kernels (``csrc/gmm_score.cu``'s sentence kernel,
  ``csrc/hmm_banded.cu``) — and npz checkpoints;
* scheme-1 training — per-senone frame buckets from uniform segmentation
  or realignment, grouped k-means and EM (:mod:`~poccala_tpu_torch.ops.
  kmeans`, :mod:`~poccala_tpu_torch.ops.em`), split-and-merge EM
  (:mod:`~poccala_tpu_torch.train.smem`), mixture growth — plus k-means
  state tying and the reference's per-unit parameter layout;
* context-dependent units (:mod:`~poccala_tpu_torch.models.context`), the
  parallel tier over ``torch.distributed``
  (:mod:`~poccala_tpu_torch.parallel`), the command line
  (:mod:`~poccala_tpu_torch.cli`) and the leaf modules (distances,
  hierarchical clustering, SOM and PSO, the experiment-dataset loader,
  profiling).

On the GPU each kernel launches; on the CPU its plain PyTorch version runs.
"""

__version__ = "0.1.0"

from poccala_tpu_torch.config import Config, FrontendConfig, ModelConfig, TrainConfig

__all__ = [
    "Config",
    "FrontendConfig",
    "ModelConfig",
    "TrainConfig",
    "__version__",
]

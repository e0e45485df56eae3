"""Host-side IO: unit inventories, corpus scanning and batching, the
synthetic corpus, WAV files (:mod:`.wav`), audio devices
(:mod:`.audio_device`) and the experiment-dataset loader
(:mod:`.dataset`)."""

from poccala_tpu_torch.io.wav import load_wav, preprocess_signal, write_wav

__all__ = ["load_wav", "preprocess_signal", "write_wav"]

"""Host-side IO: unit inventories, corpus scanning and batching, the
synthetic corpus.  WAV IO is ``poccala_tpu.io.wav``, which is jax-free and
reused as it is."""

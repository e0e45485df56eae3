"""Host-side IO: unit inventories.  WAV IO is ``poccala_tpu.io.wav``,
which is jax-free and reused as it is."""

"""Host-side IO: unit inventories, corpus scanning and batching, the
synthetic corpus, WAV files (:mod:`.wav`) and audio devices
(:mod:`.audio_device`)."""

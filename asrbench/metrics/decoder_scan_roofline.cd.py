"""``decoder_scan_roofline``, read in the CD decode cells, which report
``decode_audio_s_per_s.cd``."""

from asrbench.harness.spec import metric_reader

read = metric_reader("decoder_scan_roofline")

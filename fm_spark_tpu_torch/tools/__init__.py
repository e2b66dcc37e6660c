"""Operational tools of the port, run as modules (``python -m
fm_spark_tpu_torch.tools.<name>``): :mod:`.chaos_drill`, the chaos
campaign's runner."""

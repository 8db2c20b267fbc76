"""The benchmark of ``h264tpu_torch`` (entry point: ``benchmark/run.py``)."""

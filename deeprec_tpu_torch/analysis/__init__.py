"""Thread-safety annotations (`annotations.py`): the port's copy of
`deeprec_tpu/analysis/annotations.py`."""

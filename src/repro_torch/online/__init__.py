"""The workload contract of the online loop (``online/workload.py``)."""

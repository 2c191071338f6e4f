"""The benchmark of ``repro_torch`` on one H100: ``python3 portbench/run.py``.

Everything that measures lives here (traffic, the reduction of traces to
metrics, the peaks, the byte counts, the plain reference and the check that
decides ``correct``); the program under test is ``src/repro_torch``.
"""

"""The benchmark of the PyTorch and CUDA port (``attention_based_tbn_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Everything is found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``drivers/<driver>.py``, ``metrics/<metric>.py``,
``limits/<cell>.json``; ``reference/`` is the plain float32 model and
``costs/`` the operation and byte counts and the card's peaks.
"""

"""The benchmark of ``asr_streaming_tpu_torch``: one run of one cell with
``python3 -m perfbench.run`` (see ``run.py``); the cells, configurations,
traffic mixes and metric readers are files found by the names in
``BENCHMARK.json``."""

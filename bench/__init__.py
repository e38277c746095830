"""The benchmark of the PyTorch and CUDA port of Dash (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Configurations, traffic mixes,
cells and per-layer metrics are files of their own under this folder, found
by the names ``BENCHMARK.json`` gives them.

Tests: ``python -m pytest bench/`` on the CPU (tiny sizes, the card's tests
skipped); ``python -m pytest -m card bench/`` runs the card's tests on a
machine with a CUDA card.
"""

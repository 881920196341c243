"""The benchmark of tputracer_torch (see BENCHMARK.json and run.py)."""

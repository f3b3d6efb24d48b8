"""The benchmark of videoitg_tpu_torch on one NVIDIA GPU (see BENCHMARK.json)."""

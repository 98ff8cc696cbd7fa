"""The port's benchmark: a harness outside the program, driven by BENCHMARK.json."""

"""One reader a metric, found by the metric's name in BENCHMARK.json.

Each module has ``UNIT`` and ``read(run) -> float | None``; ``run`` holds
the window's stamps, the program's spans, the work the stored frames
needed and, in a traced run, the device's activity. A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""

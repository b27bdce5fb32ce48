"""One module a metric, named as the metric in BENCHMARK.json; ``read(run)`` gives its value or None."""

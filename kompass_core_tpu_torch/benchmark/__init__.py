from .runner import BenchmarkRunner, measure_performance  # noqa: F401

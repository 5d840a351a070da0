"""Batch job system: queue, workers, retry/backoff, exports, script engine."""

"""Host runtime: sensor accumulation, the pipeline, timers, evaluation."""

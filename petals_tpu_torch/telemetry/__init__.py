"""Telemetry: the step-program observatory (captures, replays and
capture-aware kernel launch counts of the CUDA-graph step programs)."""

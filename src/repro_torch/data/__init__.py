"""The deterministic synthetic token pipeline."""

"""Wall-clock durations for progress lines."""

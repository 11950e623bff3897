"""The fault-tolerant training loop."""

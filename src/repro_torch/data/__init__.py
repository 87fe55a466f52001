"""The deterministic synthetic token stream (`pipeline`)."""

"""The train step: loss, gradients, AdamW (`step`)."""

"""Host utilities: calibration checkpoints."""

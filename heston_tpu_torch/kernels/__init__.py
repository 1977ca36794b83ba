"""Hand-written GPU kernels with their host sides and plain versions."""

"""Driver utilities of the port: preemption-safe training and experiment
logs."""

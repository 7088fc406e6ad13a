"""The harness: cells found by name, traffic, weights, the window, the trace and the check."""

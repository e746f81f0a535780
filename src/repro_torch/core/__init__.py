"""core: routing, the single-device embedding layer, the host lookup engine,
the adaptive-cache controller and credit flow control."""

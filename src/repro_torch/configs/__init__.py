"""configs subpackage: model configurations (``make_config`` per module)."""

"""Device introspection and timing for the port's entry points."""

"""Command-line entry points of the port: ``serve`` (the serve CLI)."""

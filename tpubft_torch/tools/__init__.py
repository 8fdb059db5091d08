"""Command-line tools of the port (port of the reference's tools/)."""

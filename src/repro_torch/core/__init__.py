"""Core GEE: options, backends, the plan layer and the public API."""

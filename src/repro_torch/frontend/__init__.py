"""Serving front end of the port: so far the chunked-prefill planner."""

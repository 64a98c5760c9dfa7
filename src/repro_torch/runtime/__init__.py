"""Elastic scaling of the port's mesh state (``elastic``)."""

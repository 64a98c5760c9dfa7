"""Numeric core of the port: precision policies, ground distances and the
batched LC-ACT / LC-RWMD engines."""

"""Logging and small helpers of the port."""

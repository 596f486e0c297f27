"""Sweep launcher of the port."""
